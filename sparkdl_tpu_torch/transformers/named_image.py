"""Named pretrained-model transformers — counterpart of
``sparkdl_tpu/transformers/named_image.py::DeepImageFeaturizer``
(``DeepImagePredictor`` is a later slice)."""

from __future__ import annotations

from sparkdl_tpu_torch.params import (
    HasBatchSize,
    HasDevice,
    HasDeviceResizeFrom,
    HasInputCol,
    HasOutputCol,
    Param,
    Transformer,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.transformers.image_transform import ImageTransformer


class _HasModelName(Transformer):
    modelName = Param("_HasModelName", "modelName",
                      "named zoo model (see models.zoo.SUPPORTED_MODELS)",
                      TypeConverters.toString)

    def setModelName(self, value: str):
        return self._set(modelName=value)

    def getModelName(self) -> str:
        return self.getOrDefault("modelName")


class DeepImageFeaturizer(_HasModelName, HasInputCol, HasOutputCol,
                          HasBatchSize, HasDeviceResizeFrom, HasDevice):
    """Image column → penultimate-layer feature vector of a named model,
    for transfer learning. ``device=None`` runs on the card (and raises
    without one); ``device="cpu"`` runs on the CPU."""

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelName=None,
                 batchSize=64, deviceResizeFrom=None, device=None):
        super().__init__()
        self._setDefault(batchSize=64, deviceResizeFrom=None, device=None)
        self._set(inputCol=inputCol, outputCol=outputCol,
                  modelName=modelName, batchSize=batchSize,
                  deviceResizeFrom=deviceResizeFrom, device=device)
        self.metrics = None

    def _transform(self, dataset):
        from sparkdl_tpu_torch.models import zoo
        mf = zoo.getModelFunction(self.getModelName(), featurize=True,
                                  device=self.getDevice())
        inner = ImageTransformer(
            inputCol=self.getInputCol(), outputCol=self.getOutputCol(),
            modelFunction=mf, batchSize=self.getBatchSize(),
            deviceResizeFrom=self.getOrDefault("deviceResizeFrom"))
        self.metrics = inner.metrics
        return inner.transform(dataset)
