"""ImageTransformer: apply a model function to an image column —
counterpart of ``sparkdl_tpu/transformers/image_transform.py``.

Two stages per partition: a host stage packs the image structs into
uint8 NHWC, then a device stage runs the model through the batch runner
and appends the output column. The device stage's batch hint follows
the runner's device batch, so the engine feeds it blocks cut at that
batch across partition boundaries."""

from __future__ import annotations

import dataclasses

import numpy as np

from sparkdl_tpu_torch.data.frame import LiveBatchHint, column
from sparkdl_tpu_torch.data.tensors import append_tensor_column
from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasDeviceResizeFrom,
    HasInputCol,
    HasModelFunction,
    HasOutputCol,
    HasOutputMode,
    Transformer,
    keyword_only,
)
from sparkdl_tpu_torch.runtime.runner import RunnerMetrics
from sparkdl_tpu_torch.transformers import utils as tfr_utils

_PACKED_COL = "__sparkdl_tpu_torch_packed__"


@dataclasses.dataclass(frozen=True)
class PackImages:
    """The host stage: an image struct column → uint8 NHWC (resized on
    the host unless the device resizes), cast to the model's input
    dtype, appended as the packed column. It holds no model or runner,
    so it ships to the host pipeline's worker processes."""
    in_col: str
    height: int
    width: int
    channels: int
    resize: bool
    in_dtype: object

    def __call__(self, batch):
        arr = tfr_utils.packImageBatch(column(batch, self.in_col),
                                       self.height, self.width,
                                       self.channels, resize=self.resize)
        if np.dtype(self.in_dtype) != np.uint8:
            arr = arr.astype(self.in_dtype)
        return append_tensor_column(batch, _PACKED_COL, arr)


class ImageTransformer(Transformer, HasInputCol, HasOutputCol,
                       HasModelFunction, HasOutputMode, HasBatchSize,
                       HasDeviceResizeFrom):
    """Applies a single-input ModelFunction (on its own device) to an
    image struct column. ``outputMode="vector"`` (the default) gives each
    row's output flattened to a float32 vector; ``"image"`` turns an
    [N, H, W, C] output into image structs.

    ``deviceResizeFrom=(H, W)``: the images are all H×W; the host packs
    them as they are and the resize to the model's input size runs on
    the device, by the CUDA resize kernel on the card. When (H, W) is
    the model's own input size there is nothing to resize on the device:
    the host path runs, and resizes any off-size row, as in the JAX
    package."""

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelFunction=None,
                 outputMode="vector", batchSize=64, deviceResizeFrom=None):
        super().__init__()
        self._setDefault(outputMode="vector", batchSize=64,
                         deviceResizeFrom=None)
        self._set(inputCol=inputCol, outputCol=outputCol,
                  modelFunction=modelFunction, outputMode=outputMode,
                  batchSize=batchSize, deviceResizeFrom=deviceResizeFrom)
        self.metrics = RunnerMetrics()

    def _transform(self, dataset):
        mf = self.getModelFunction()
        in_name, out_name = tfr_utils.single_io(mf)
        shape, in_dtype = mf.input_signature[in_name]
        if len(shape) != 3:
            raise ValueError(f"model input must be HWC, got shape {shape}")
        src_hw = self.getOrDefault("deviceResizeFrom")
        if src_hw is not None:
            wrapped = tfr_utils.deviceResizeModel(mf, src_hw)
            if wrapped is mf:
                src_hw = None   # (H, W) is the model's size: host path
            else:
                mf = wrapped
                shape, in_dtype = mf.input_signature[in_name]
        h, w, c = shape
        in_col = self.getInputCol()
        out_col = self.getOutputCol()
        mode = self.getOutputMode()
        runner = tfr_utils.make_runner(mf, self.getBatchSize(),
                                       metrics=self.metrics)

        pack = PackImages(in_col, h, w, c, src_hw is None, in_dtype)

        def apply(batch):
            out = runner.run({in_name: batch[_PACKED_COL]})[out_name]
            batch = {k: v for k, v in batch.items() if k != _PACKED_COL}
            return tfr_utils.appendModelOutput(batch, out_col, out, mode)

        return dataset.map_batches(pack, name="packImageBatch") \
            .map_batches(apply, kind="device", name=f"apply({mf.name})",
                         batch_hint=LiveBatchHint(runner))
