"""Named batch-UDF registry — counterpart of
``sparkdl_tpu/udf/registry.py`` (the reference's
``graph/tensorframes_udf.py::makeGraphUDF``, which registered a frozen TF
graph as a named Spark SQL function). A :class:`ModelUDF` wraps a
:class:`~sparkdl_tpu_torch.graph.function.ModelFunction` in a
process-wide catalog and is called three ways:

* ``udf.apply(df, inputCol, outputCol)`` — columnar, the SQL
  ``SELECT udf(col)`` analogue, through the Image or Tensor transformer,
  so it runs as those pipeline stages run;
* ``udf(ndarray)`` — a direct batched call on host arrays;
* by name from anywhere in the process, :func:`callUDF`.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np

from sparkdl_tpu_torch.graph.function import ModelFunction


class ModelUDF:
    """A named model applied to frame columns. ``kind="image"`` applies
    it to an image struct column (host pack → the model's device),
    ``"tensor"`` to a numeric or tensor column."""

    def __init__(self, name: str, model_fn: ModelFunction,
                 kind: str = "tensor", batch_size: int = 64):
        if kind not in ("image", "tensor"):
            raise ValueError(f"kind must be 'image' or 'tensor', got {kind!r}")
        self.name = name
        self.model_fn = model_fn
        self.kind = kind
        self.batch_size = batch_size

    def apply(self, dataset, inputCol: str, outputCol: str,
              outputMode: str = "vector", batchSize: Optional[int] = None):
        """Columnar application — the ``SELECT udf_name(col)`` analogue."""
        bs = batchSize or self.batch_size
        if self.kind == "image":
            from sparkdl_tpu_torch.transformers.image_transform import (
                ImageTransformer,
            )
            t = ImageTransformer(inputCol=inputCol, outputCol=outputCol,
                                 modelFunction=self.model_fn,
                                 outputMode=outputMode, batchSize=bs)
        else:
            from sparkdl_tpu_torch.transformers.tensor_transform import (
                TensorTransformer,
            )
            from sparkdl_tpu_torch.transformers.utils import single_io
            in_name, out_name = single_io(self.model_fn)
            t = TensorTransformer(modelFunction=self.model_fn,
                                  inputMapping={inputCol: in_name},
                                  outputMapping={out_name: outputCol},
                                  batchSize=bs)
        return t.transform(dataset)

    def __call__(self, inputs):
        """Direct batched call on host arrays (a single-input model takes
        a bare ndarray; a multi-input one ``{name: ndarray}``)."""
        from sparkdl_tpu_torch.transformers.utils import make_runner
        runner = make_runner(self.model_fn, self.batch_size)
        if not isinstance(inputs, dict):
            (in_name,) = self.model_fn.input_names
            _, dtype = self.model_fn.input_signature[in_name]
            inputs = {in_name: np.asarray(inputs).astype(dtype, copy=False)}
        out = runner.run({k: np.asarray(v) for k, v in inputs.items()})
        if len(out) == 1:
            return next(iter(out.values()))
        return out

    def __repr__(self) -> str:
        return (f"ModelUDF({self.name!r}, kind={self.kind}, "
                f"model={self.model_fn.name})")


_registry: Dict[str, ModelUDF] = {}
_registry_lock = threading.Lock()


def registerUDF(udf: ModelUDF, replace: bool = False) -> ModelUDF:
    """Install a UDF into the process-wide catalog."""
    with _registry_lock:
        if udf.name in _registry and not replace:
            raise ValueError(
                f"UDF {udf.name!r} already registered; pass replace=True "
                "to overwrite")
        _registry[udf.name] = udf
    return udf


def makeModelUDF(model_fn: ModelFunction, udf_name: str,
                 kind: str = "tensor", batch_size: int = 64,
                 register: bool = True, replace: bool = False) -> ModelUDF:
    """Wrap and (by default) register a ModelFunction as a named UDF (the
    reference's ``makeGraphUDF(graph, udf_name, ..., register)``; its
    fetches and feeds are the ModelFunction's named IO)."""
    udf = ModelUDF(udf_name, model_fn, kind=kind, batch_size=batch_size)
    if register:
        registerUDF(udf, replace=replace)
    return udf


def getUDF(name: str) -> ModelUDF:
    with _registry_lock:
        if name not in _registry:
            raise KeyError(
                f"no UDF named {name!r}; registered: {sorted(_registry)}")
        return _registry[name]


def unregisterUDF(name: str) -> bool:
    with _registry_lock:
        return _registry.pop(name, None) is not None


def listUDFs() -> List[str]:
    with _registry_lock:
        return sorted(_registry)


def callUDF(name: str, dataset, inputCol: str, outputCol: str, **kwargs):
    """Apply a registered UDF by name (the SQL-call analogue)."""
    return getUDF(name).apply(dataset, inputCol, outputCol, **kwargs)
