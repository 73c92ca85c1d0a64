"""Tensor-column helpers — counterpart of ``sparkdl_tpu/data/tensors.py``.

A batch is an ordered ``dict`` of column name → ndarray with one entry
per row. A tensor column is a numeric ``[N, *shape]`` array; strings and
structs are object arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

Batch = Dict[str, np.ndarray]


def append_unique_column(batch: Batch, name: str,
                         column: np.ndarray) -> Batch:
    """A new batch with ``column`` appended; an existing name RAISES
    (Spark ML's "output column already exists")."""
    if name in batch:
        raise ValueError(
            f"output column {name!r} already exists; choose a "
            "different output column or drop/rename the existing one "
            "first")
    out = dict(batch)
    out[name] = column
    return out


def append_tensor_column(batch: Batch, name: str, array: np.ndarray,
                         replace: bool = False) -> Batch:
    """Append ndarray [N, *shape] as a tensor column (``replace=True``
    swaps an existing column in place, keeping its position)."""
    array = np.asarray(array)
    rows = next(iter(batch.values())).shape[0] if batch else len(array)
    if len(array) != rows:
        raise ValueError(
            f"column {name!r} has {len(array)} rows, the batch {rows}")
    if replace and name in batch:
        out = dict(batch)
        out[name] = array
        return out
    return append_unique_column(batch, name, array)


def column_to_tensor(column: np.ndarray) -> np.ndarray:
    """Tensor column → ndarray [N, *shape]: a numeric array as it is, an
    object array of equal-shape rows stacked."""
    column = np.asarray(column)
    if column.dtype != object:
        return column
    if len(column) == 0:
        return np.zeros((0,), np.float32)
    return np.stack([np.asarray(v) for v in column])


def column_values(column: np.ndarray) -> np.ndarray:
    """A scalar column's values as an array: an object column (Python
    values, e.g. from ``from_pylist``) becomes ``np.asarray`` of them, as
    the JAX package reads a column through its Python values."""
    column = np.asarray(column)
    return np.asarray(column.tolist()) if column.dtype == object else column
