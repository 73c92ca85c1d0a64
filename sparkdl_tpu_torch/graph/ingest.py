"""ModelIngest: model ingestion into a ModelFunction — counterpart of
``sparkdl_tpu/graph/ingest.py`` (the reference's ``TFInputGraph``).

==============================  ============================================
reference source                the port's source
==============================  ============================================
tf.Graph in a session           ``fromFunction`` (an ``nn.Module``, or a
                                torch function with a dict of params)
frozen GraphDef bytes           ``fromExport`` (``ModelFunction.export``'s
                                bytes, the port's frozen form)
Keras .h5 / .keras model file   ``fromKerasFile`` / ``fromKerasModel``
                                (converted to a torch module:
                                ``graph/keras_convert.py``)
==============================  ============================================

The JAX package also reads TF-era artifacts (GraphDef, SavedModel,
checkpoints) and runs them on the host through the TF runtime; the port
has no host-backend ModelFunction yet, so those sources are not here.
keras is imported only inside the Keras constructors.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
from torch import nn

from sparkdl_tpu_torch._device import DeviceLike
from sparkdl_tpu_torch.graph.function import (
    ModelFunction,
    ParamBuffers,
    Signature,
)


class _Function(nn.Module):
    """``fn(params, inputs) -> outputs`` over dicts, ``params`` held as
    buffers."""

    def __init__(self, fn: Callable, params: Optional[Dict[str, Any]]):
        super().__init__()
        self.fn = fn
        self.params = None if params is None else ParamBuffers(params)

    def forward(self, inputs):
        return self.fn(None if self.params is None
                       else self.params.as_dict(), inputs)


class ModelIngest:
    """Namespace of ingestion constructors; each returns a
    :class:`ModelFunction` on ``device`` (``None`` = the card)."""

    @staticmethod
    def fromFunction(fn: Callable, params: Optional[Dict[str, Any]] = None,
                     input_signature: Optional[Signature] = None,
                     input_shape: Optional[Tuple[int, ...]] = None,
                     input_dtype=np.float32, name: str = "torch_fn",
                     device: DeviceLike = None) -> ModelFunction:
        """An ``nn.Module`` taking and returning dicts of named tensors, or
        ``fn(params, inputs_dict) -> outputs_dict`` with ``params`` a flat
        dict of tensors, each with an explicit ``input_signature``; or a
        single-tensor ``fn(params, x)`` / ``fn(x)`` with ``input_shape``."""
        if input_signature is not None:
            module = (fn if isinstance(fn, nn.Module) and params is None
                      else _Function(fn, params))
            return ModelFunction(module, input_signature, device=device,
                                 name=name)
        if input_shape is None:
            raise ValueError("need input_signature or input_shape")
        return ModelFunction.fromSingle(
            fn, params, input_shape=input_shape, input_dtype=input_dtype,
            name=name, device=device)

    @staticmethod
    def fromExport(blob: bytes, name: str = "exported",
                   device: DeviceLike = None) -> ModelFunction:
        """Bytes of ``ModelFunction.export`` — the frozen form (reference:
        frozen GraphDef bytes)."""
        return ModelFunction.deserialize(blob, name=name, device=device)

    @staticmethod
    def fromKerasModel(model, name: Optional[str] = None,
                       device: DeviceLike = None) -> ModelFunction:
        """A single-input Keras 3 model, on any Keras backend, converted to
        a torch module with its weights (``graph/keras_convert.py``):
        input ``"input"``, outputs ``"output_0"``, ...; a layer the
        converter does not know raises ``NotImplementedError``."""
        from sparkdl_tpu_torch.graph.keras_convert import convert_model
        module, in_shape, in_dtype, out_names = convert_model(model)
        return ModelFunction(
            module, {"input": (in_shape, np.dtype(in_dtype))}, out_names,
            device=device, name=name or f"keras:{model.name}")

    @staticmethod
    def fromKerasFile(path: str, name: Optional[str] = None,
                      device: DeviceLike = None) -> ModelFunction:
        """A Keras model file (``.h5`` legacy or ``.keras``), loaded by the
        installed keras and converted (reference
        ``KerasImageFileTransformer.modelFile``)."""
        import keras
        model = keras.models.load_model(path, compile=False)
        return ModelIngest.fromKerasModel(
            model, name=name or f"keras:{os.path.basename(path)}",
            device=device)


# Reference-era alias: sparkdl users know this class as TFInputGraph.
TFInputGraph = ModelIngest
