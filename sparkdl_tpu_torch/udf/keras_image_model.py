"""registerKerasImageUDF: a Keras model as a named image UDF —
counterpart of ``sparkdl_tpu/udf/keras_image_model.py`` (the reference's
``registerKerasImageUDF(name, model_or_file, preprocessor=None)``, which
composed ``GraphFunction.fromList([converter, (preprocessor), model])``).
Here the Keras model is converted to a torch module
(``ModelIngest.fromKerasModel``), and the optional preprocessor, a torch
function, runs inside the composed module on the model's device."""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sparkdl_tpu_torch._device import DeviceLike
from sparkdl_tpu_torch.graph.function import ModelFunction, torch_dtype
from sparkdl_tpu_torch.udf.registry import ModelUDF, makeModelUDF


class _ImageModel(nn.Module):
    """uint8 ``image`` → (float32 → ``preprocessor``) → the model's input
    dtype → the model."""

    def __init__(self, model: nn.Module, model_in: str,
                 dtype: torch.dtype, preprocessor: Optional[Callable]):
        super().__init__()
        self.model = model
        self.model_in = model_in
        self.dtype = dtype
        self.preprocessor = preprocessor

    def forward(self, inputs):
        x = inputs["image"]
        if self.preprocessor is not None:
            x = self.preprocessor(x.to(torch.float32))
        return self.model({self.model_in: x.to(self.dtype)})


def _composed_image_fn(model_mf: ModelFunction,
                       preprocessor: Optional[Callable],
                       input_size: Optional[Tuple[int, int]],
                       name: str) -> ModelFunction:
    """[uint8 image batch → (preprocessor) → model] as one ModelFunction.

    Without a preprocessor the UDF's input is the model's own HWC shape.
    With one, ``preprocessor(float32 [N, h, w, c] in 0..255)`` gives the
    model's input batch; ``input_size`` sets (h, w) where it differs
    from the model's."""
    (model_in,) = model_mf.input_names
    m_shape, m_dtype = model_mf.input_signature[model_in]
    if len(m_shape) != 3:
        raise ValueError(
            f"registerKerasImageUDF needs an HWC image model, got input "
            f"shape {m_shape}")
    h, w, c = m_shape
    if preprocessor is not None and input_size is not None:
        h, w = input_size
    return ModelFunction(
        _ImageModel(model_mf.module, model_in, torch_dtype(m_dtype),
                    preprocessor),
        {"image": ((h, w, c), np.uint8)}, model_mf.output_names,
        device=model_mf.device, name=name)


def registerKerasImageUDF(udf_name: str, keras_model_or_file,
                          preprocessor: Optional[Callable] = None,
                          input_size: Optional[Tuple[int, int]] = None,
                          batch_size: int = 64, register: bool = True,
                          replace: bool = False, session=None,
                          device: DeviceLike = None) -> ModelUDF:
    """Register a Keras model (object or ``.h5`` / ``.keras`` path) as a
    named image UDF on ``device`` (``None`` = the card); apply it with
    ``callUDF(udf_name, df, "image", "out")`` or ``udf.apply(...)``.

    ``session=`` (registering the UDF as a SQL function on a Spark
    session) needs the port of ``data/spark_binding.py``, which is not
    done: it raises ``NotImplementedError``."""
    if session is not None:
        raise NotImplementedError(
            "registerKerasImageUDF(session=...) needs data/spark_binding.py, "
            "which the port does not have yet (ROADMAP queue A, "
            "'data/spark_binding.py')")
    from sparkdl_tpu_torch.graph.ingest import ModelIngest
    if isinstance(keras_model_or_file, str):
        model_mf = ModelIngest.fromKerasFile(keras_model_or_file,
                                             device=device)
    else:
        model_mf = ModelIngest.fromKerasModel(keras_model_or_file,
                                              device=device)
    composed = _composed_image_fn(model_mf, preprocessor, input_size,
                                  name=f"udf:{udf_name}")
    return makeModelUDF(composed, udf_name, kind="image",
                        batch_size=batch_size, register=register,
                        replace=replace)
