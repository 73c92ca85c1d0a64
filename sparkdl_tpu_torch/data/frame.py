"""Immutable partitioned frame over numpy batches — counterpart of
``sparkdl_tpu/data/frame.py`` for the operations the port's pipelines
use.

A partition is a :class:`Source` that loads one batch (an ordered dict
of column → ndarray); a frame is its sources plus a plan of
batch → batch stages, run lazily by the engine when the frame is
collected. There is no pyarrow: strings and image structs are object
arrays, tensor columns are ``[N, *shape]`` arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.data.tensors import Batch, column_to_tensor


@dataclasses.dataclass(frozen=True)
class Stage:
    """One plan step: batch → batch."""
    fn: Callable[[Batch], Batch]
    name: str = "stage"
    row_preserving: bool = True


@dataclasses.dataclass(frozen=True)
class Source:
    """One partition: ``load`` materializes its batch; ``num_rows`` is a
    count known without loading (None = unknown)."""
    load: Callable[[], Batch]
    num_rows: Optional[int] = None


def column(batch: Batch, name: str) -> np.ndarray:
    """A batch's column by name, with an error that lists the columns."""
    if name not in batch:
        raise KeyError(f"no column {name!r}; columns are {list(batch)}")
    return batch[name]


def to_column(values: Sequence) -> np.ndarray:
    """Row values → a column: numeric scalars become a numeric array,
    anything else (strings, dicts, arrays, None) an object array."""
    if all(isinstance(v, (bool, int, float, np.number)) for v in values) \
            and len(values):
        return np.asarray(values)
    col = np.empty(len(values), dtype=object)
    col[:] = list(values)
    return col


def concat_batches(batches: List[Batch]) -> Batch:
    if not batches:
        return {}
    return {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}


def num_rows(batch: Batch) -> int:
    return len(next(iter(batch.values()))) if batch else 0


class DataFrame:
    """Immutable partitioned frame; transforms return new frames."""

    def __init__(self, sources: Sequence[Source],
                 plan: Sequence[Stage] = ()):
        self._sources: List[Source] = list(sources)
        self._plan: List[Stage] = list(plan)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_columns(columns: Batch,
                     num_partitions: int = 8) -> "DataFrame":
        """One batch of columns split into up to ``num_partitions``
        contiguous row ranges."""
        n = num_rows(columns)
        num_partitions = max(1, min(num_partitions, n) if n else 1)
        bounds = np.linspace(0, n, num_partitions + 1).astype(int)
        sources = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = {k: v[lo:hi] for k, v in columns.items()}
            sources.append(Source(lambda part=part: part, int(hi - lo)))
        return DataFrame(sources)

    @staticmethod
    def from_pylist(rows: List[dict],
                    num_partitions: int = 8) -> "DataFrame":
        names: List[str] = []
        for row in rows:
            names += [k for k in row if k not in names]
        columns = {k: to_column([row.get(k) for row in rows])
                   for k in names}
        return DataFrame.from_columns(columns, num_partitions)

    # -- plan building ------------------------------------------------------

    def map_batches(self, fn: Callable[[Batch], Batch],
                    name: str = "map_batches",
                    row_preserving: bool = True) -> "DataFrame":
        return DataFrame(self._sources,
                         self._plan + [Stage(fn, name, row_preserving)])

    def filter(self, predicate: Callable[[Batch], np.ndarray]
               ) -> "DataFrame":
        """Keep the rows where ``predicate(batch)`` (a bool mask) holds."""
        def _stage(batch: Batch) -> Batch:
            mask = np.asarray(predicate(batch), dtype=bool)
            return {k: v[mask] for k, v in batch.items()}

        return self.map_batches(_stage, name="filter", row_preserving=False)

    # -- materialization ----------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return len(self._sources)

    def stream(self) -> Iterator[Batch]:
        """Ordered iterator of fully transformed partition batches."""
        from sparkdl_tpu_torch.data.engine import execute
        return execute(self._sources, self._plan)

    @property
    def columns(self) -> List[str]:
        """Column names (runs the plan on the first partition)."""
        for batch in self.stream():
            return list(batch)
        return []

    def collect(self) -> Batch:
        """The whole frame as one batch."""
        return concat_batches(list(self.stream()))

    def collect_rows(self) -> List[dict]:
        batch = self.collect()
        return [{k: v[i] for k, v in batch.items()}
                for i in range(num_rows(batch))]

    def count(self) -> int:
        if all(st.row_preserving for st in self._plan) and \
                all(s.num_rows is not None for s in self._sources):
            return sum(s.num_rows for s in self._sources)
        return sum(num_rows(b) for b in self.stream())

    def tensor(self, col: str) -> np.ndarray:
        """One tensor column as a stacked ndarray [N, *shape]."""
        return column_to_tensor(column(self.collect(), col))

    def __repr__(self) -> str:
        return (f"DataFrame({len(self._sources)} partitions, "
                f"{len(self._plan)} stages)")
