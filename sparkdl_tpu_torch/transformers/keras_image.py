"""KerasImageFileTransformer: an image-URI column → a user Keras model's
output — counterpart of ``sparkdl_tpu/transformers/keras_image.py``
(params ``modelFile``, ``imageLoader``, ``outputMode``). The user's
``imageLoader(uri) -> ndarray`` runs in a host stage; the model file is
read by the installed keras, converted to a torch module
(``ModelIngest.fromKerasFile``) and run by the batch runner on the
model's device. The JAX package's ``useMesh`` is left out, as on the
port's other transformers."""

from __future__ import annotations

from sparkdl_tpu_torch.data.frame import LiveBatchHint, column
from sparkdl_tpu_torch.data.tensors import column_to_tensor
from sparkdl_tpu_torch.params import (
    CanLoadImage,
    HasBatchSize,
    HasDevice,
    HasInputCol,
    HasKerasModel,
    HasOutputCol,
    HasOutputMode,
    Transformer,
    keyword_only,
)
from sparkdl_tpu_torch.runtime.runner import RunnerMetrics
from sparkdl_tpu_torch.transformers import utils as tfr_utils

_LOADED_COL = "__sparkdl_tpu_torch_loaded__"


class KerasImageFileTransformer(Transformer, HasInputCol, HasOutputCol,
                                HasKerasModel, HasOutputMode, HasBatchSize,
                                CanLoadImage, HasDevice):
    """The model runs on ``device`` (``None`` = the card)."""

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelFile=None,
                 imageLoader=None, outputMode="vector", batchSize=64,
                 device=None):
        super().__init__()
        self._setDefault(outputMode="vector", batchSize=64, device=None)
        self._set(inputCol=inputCol, outputCol=outputCol,
                  modelFile=modelFile, imageLoader=imageLoader,
                  outputMode=outputMode, batchSize=batchSize,
                  device=device)
        self.metrics = RunnerMetrics()

    def _transform(self, dataset):
        from sparkdl_tpu_torch.graph.ingest import ModelIngest
        mf = ModelIngest.fromKerasFile(self.getModelFile(),
                                       device=self.getDevice())
        in_name, out_name = tfr_utils.single_io(mf)
        out_col = self.getOutputCol()
        mode = self.getOutputMode()
        runner = tfr_utils.make_runner(mf, self.getBatchSize(),
                                       metrics=self.metrics)
        shape, dtype = mf.input_signature[in_name]

        def apply(batch):
            arr = tfr_utils.reshapeLoadedRows(
                column_to_tensor(column(batch, _LOADED_COL)), shape, dtype,
                mf.name)
            out = runner.run({in_name: arr})[out_name]
            batch = {k: v for k, v in batch.items() if k != _LOADED_COL}
            return tfr_utils.appendModelOutput(batch, out_col, out, mode)

        loaded = self.loadImagesInternal(dataset, self.getInputCol(),
                                         _LOADED_COL)
        return loaded.map_batches(apply, kind="device",
                                  name=f"apply({mf.name})",
                                  batch_hint=LiveBatchHint(runner))
