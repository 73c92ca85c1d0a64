"""KerasTransformer: a tensor column → a user Keras model's output —
counterpart of ``sparkdl_tpu/transformers/keras_tensor.py`` (param
``modelFile``). The model file is read by the installed keras and
converted (``ModelIngest.fromKerasFile``), then applied by
:class:`TensorTransformer`."""

from __future__ import annotations

from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasDevice,
    HasInputCol,
    HasKerasModel,
    HasOutputCol,
    Transformer,
    keyword_only,
)


class KerasTransformer(Transformer, HasInputCol, HasOutputCol,
                       HasKerasModel, HasBatchSize, HasDevice):
    """The model runs on ``device`` (``None`` = the card)."""

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelFile=None,
                 batchSize=64, device=None):
        super().__init__()
        self._setDefault(batchSize=64, device=None)
        self._set(inputCol=inputCol, outputCol=outputCol,
                  modelFile=modelFile, batchSize=batchSize, device=device)
        self.metrics = None

    def _transform(self, dataset):
        from sparkdl_tpu_torch.graph.ingest import ModelIngest
        from sparkdl_tpu_torch.transformers.tensor_transform import (
            TensorTransformer,
        )
        from sparkdl_tpu_torch.transformers.utils import single_io

        mf = ModelIngest.fromKerasFile(self.getModelFile(),
                                       device=self.getDevice())
        in_name, out_name = single_io(mf)
        inner = TensorTransformer(
            modelFunction=mf,
            inputMapping={self.getInputCol(): in_name},
            outputMapping={out_name: self.getOutputCol()},
            batchSize=self.getBatchSize())
        self.metrics = inner.metrics
        return inner.transform(dataset)
