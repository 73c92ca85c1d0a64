"""Named pretrained-model transformers — counterpart of
``sparkdl_tpu/transformers/named_image.py``: ``DeepImageFeaturizer``
(penultimate-layer features for transfer learning) and
``DeepImagePredictor`` (class scores, optionally decoded to top-K
``(class, description, score)`` rows)."""

from __future__ import annotations

import numpy as np

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
from sparkdl_tpu_torch.data.frame import column, to_column
from sparkdl_tpu_torch.data.tensors import append_unique_column
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


class DeepImagePredictor(_HasModelName, HasInputCol, HasOutputCol,
                         HasBatchSize, HasDeviceResizeFrom, HasDevice):
    """Image column → class scores of a named model (softmax
    probabilities), or with ``decodePredictions`` each row's top
    ``topK`` classes as a list of ``{"class", "description", "score"}``
    dicts, best first, ``score`` a ``np.float32``.

    Decoded class names resolve, in order: ``classIndexFile`` (a JSON in
    keras ``imagenet_class_index`` layout), the model's own class index
    (``<model>.class_index.json`` beside its weights; the committed
    TestNet ships one), then the ImageNet index. ``device=None`` runs on
    the card (and raises without one); ``device="cpu"`` runs on the
    CPU."""

    decodePredictions = Param("DeepImagePredictor", "decodePredictions",
                              "emit top-K decoded classes instead of the "
                              "raw score vector",
                              TypeConverters.toBoolean)
    topK = Param("DeepImagePredictor", "topK", "how many classes to keep",
                 TypeConverters.toInt)
    classIndexFile = Param("DeepImagePredictor", "classIndexFile",
                           "class-index JSON overriding the model's "
                           "own / the ImageNet index",
                           TypeConverters.toString)

    @keyword_only
    def __init__(self, *, inputCol=None, outputCol=None, modelName=None,
                 decodePredictions=False, topK=5, batchSize=64,
                 deviceResizeFrom=None, classIndexFile=None, device=None):
        super().__init__()
        self._setDefault(decodePredictions=False, topK=5, batchSize=64,
                         deviceResizeFrom=None, classIndexFile=None,
                         device=None)
        self._set(inputCol=inputCol, outputCol=outputCol,
                  modelName=modelName, decodePredictions=decodePredictions,
                  topK=topK, batchSize=batchSize,
                  deviceResizeFrom=deviceResizeFrom,
                  classIndexFile=classIndexFile, device=device)
        self.metrics = None

    def _transform(self, dataset):
        from sparkdl_tpu_torch.models import zoo
        mf = zoo.getModelFunction(self.getModelName(), featurize=False,
                                  device=self.getDevice())
        out_col = self.getOutputCol()
        decode = self.getOrDefault("decodePredictions")
        raw_col = f"{out_col}__raw" if decode else out_col
        inner = ImageTransformer(
            inputCol=self.getInputCol(), outputCol=raw_col,
            modelFunction=mf, batchSize=self.getBatchSize(),
            deviceResizeFrom=self.getOrDefault("deviceResizeFrom"))
        self.metrics = inner.metrics
        result = inner.transform(dataset)
        if not decode:
            return result

        k = self.getOrDefault("topK")
        index_file = self.getOrDefault("classIndexFile")
        class_index = (zoo.load_class_index(index_file) if index_file
                       else zoo.model_class_index(self.getModelName()))

        def decode_stage(batch):
            decoded = zoo.decode_predictions(column(batch, raw_col), top=k,
                                             class_index=class_index)
            rows = [[{"class": c, "description": d,
                      "score": np.float32(score)}
                     for (c, d, score) in row] for row in decoded]
            batch = {name: v for name, v in batch.items() if name != raw_col}
            return append_unique_column(batch, out_col, to_column(rows))

        return result.map_batches(decode_stage, name="decodePredictions")
