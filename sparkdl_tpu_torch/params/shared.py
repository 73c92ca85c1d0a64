"""Shared param mixins — counterpart of ``sparkdl_tpu/params/shared.py``
for the mixins this port's stages use, plus ``HasDevice``."""

from __future__ import annotations

from sparkdl_tpu_torch.params.base import Param, Params, TypeConverters


class HasInputCol(Params):
    inputCol = Param("HasInputCol", "inputCol", "input column name",
                     TypeConverters.toString)

    def setInputCol(self, value: str):
        return self._set(inputCol=value)

    def getInputCol(self) -> str:
        return self.getOrDefault("inputCol")


class HasOutputCol(Params):
    outputCol = Param("HasOutputCol", "outputCol", "output column name",
                      TypeConverters.toString)

    def setOutputCol(self, value: str):
        return self._set(outputCol=value)

    def getOutputCol(self) -> str:
        return self.getOrDefault("outputCol")


class HasLabelCol(Params):
    labelCol = Param("HasLabelCol", "labelCol", "label column name",
                     TypeConverters.toString)

    def setLabelCol(self, value: str):
        return self._set(labelCol=value)

    def getLabelCol(self) -> str:
        return self.getOrDefault("labelCol")


def _toOutputMode(value):
    if value not in ("vector", "image"):
        raise TypeError(f"outputMode must be 'vector' or 'image', "
                        f"got {value!r}")
    return value


class HasOutputMode(Params):
    """'vector' → flat float features column; 'image' → image struct
    column."""

    outputMode = Param("HasOutputMode", "outputMode",
                       "output mode: 'vector' or 'image'", _toOutputMode)

    def setOutputMode(self, value: str):
        return self._set(outputMode=value)

    def getOutputMode(self) -> str:
        return self.getOrDefault("outputMode")


class HasBatchSize(Params):
    """Device batch size of the runner; the tail batch is padded to it,
    so the model always sees one batch shape."""

    batchSize = Param("HasBatchSize", "batchSize", "device batch size",
                      TypeConverters.toInt)

    def setBatchSize(self, value: int):
        return self._set(batchSize=value)

    def getBatchSize(self) -> int:
        return self.getOrDefault("batchSize")


class HasUseMesh(Params):
    """Run the device stage data-parallel over this process's local mesh
    (each device its rows of a global batch, the model replicated)
    instead of on one device. Runner selection lives in
    ``transformers/utils.py::make_runner``."""

    useMesh = Param("HasUseMesh", "useMesh",
                    "shard device batches over all local devices",
                    TypeConverters.toBoolean)

    def setUseMesh(self, value: bool):
        return self._set(useMesh=value)

    def getUseMesh(self) -> bool:
        return self.getOrDefault("useMesh")


class HasDeviceResizeFrom(Params):
    """Pack images at their uniform native (h, w) — host CPUs only
    decode — and resize to the model's input size on the device, by the
    CUDA resize kernel (``transformers/utils.py::deviceResizeModel``).
    None keeps the host path."""

    deviceResizeFrom = Param(
        "HasDeviceResizeFrom", "deviceResizeFrom",
        "(h, w) the images actually have; pack at that size and resize "
        "on the device (None = images already at the model size)",
        TypeConverters.toIntPairOrNone)

    def setDeviceResizeFrom(self, value):
        return self._set(deviceResizeFrom=value)

    def getDeviceResizeFrom(self):
        return self.getOrDefault("deviceResizeFrom")


class HasDevice(Params):
    """Where the model runs: None (the default) means ``"cuda"``, which
    raises without a card; ``"cpu"`` must be asked for."""

    device = Param("HasDevice", "device",
                   "torch device for the model (None = 'cuda')",
                   TypeConverters.toDevice)

    def setDevice(self, value):
        return self._set(device=value)

    def getDevice(self):
        return self.getOrDefault("device")


class HasModelFunction(Params):
    """The model param: a :class:`sparkdl_tpu_torch.graph.ModelFunction`."""

    modelFunction = Param("HasModelFunction", "modelFunction",
                          "ModelFunction (module + signature + device)",
                          TypeConverters.toModelFunction)

    def setModelFunction(self, value):
        return self._set(modelFunction=value)

    def getModelFunction(self):
        return self.getOrDefault("modelFunction")


class HasInputMapping(Params):
    """DataFrame column → model input name."""

    inputMapping = Param("HasInputMapping", "inputMapping",
                         "dict: input column name -> model input name",
                         TypeConverters.toStringDict)

    def setInputMapping(self, value):
        return self._set(inputMapping=value)

    def getInputMapping(self) -> dict:
        return self.getOrDefault("inputMapping")


class HasOutputMapping(Params):
    """Model output name → DataFrame column."""

    outputMapping = Param("HasOutputMapping", "outputMapping",
                          "dict: model output name -> output column name",
                          TypeConverters.toStringDict)

    def setOutputMapping(self, value):
        return self._set(outputMapping=value)

    def getOutputMapping(self) -> dict:
        return self.getOrDefault("outputMapping")


class HasTFHParams(Params):
    """Named constants fed to the model inputs of the same name, each
    broadcast over the rows."""

    tfHParams = Param("HasTFHParams", "tfHParams",
                      "dict: model input name -> constant value",
                      TypeConverters.toHParams)

    def __init__(self):
        super().__init__()
        self._setDefault(tfHParams=None)

    def setTFHParams(self, value):
        return self._set(tfHParams=value)

    def getTFHParams(self) -> dict:
        return self.getOrDefault("tfHParams") or {}


class HasKerasModel(Params):
    """Path to a user Keras model file (.h5 / .keras), read by the
    installed keras and converted to a torch module
    (``graph/ingest.py::ModelIngest.fromKerasFile``)."""

    modelFile = Param("HasKerasModel", "modelFile",
                      "path to Keras model file (.h5 or .keras)",
                      TypeConverters.toString)
    kerasFitParams = Param("HasKerasModel", "kerasFitParams",
                           "kwargs dict for the training loop "
                           "(epochs, batch_size, ...)")

    def setModelFile(self, value: str):
        return self._set(modelFile=value)

    def getModelFile(self) -> str:
        return self.getOrDefault("modelFile")

    def setKerasFitParams(self, value: dict):
        return self._set(kerasFitParams=dict(value))

    def getKerasFitParams(self) -> dict:
        return dict(self.getOrDefault("kerasFitParams"))


class HasKerasOptimizer(Params):
    """The optimizer: an optax name, trained with a torch optimizer that
    takes optax's defaults (``estimators/keras_image_file_estimator.py::
    OPTIMIZERS``), or a factory ``params -> torch.optim.Optimizer``."""

    kerasOptimizer = Param("HasKerasOptimizer", "kerasOptimizer",
                           "optax optimizer name or optimizer factory",
                           TypeConverters.toOptimizer)

    def setKerasOptimizer(self, value):
        return self._set(kerasOptimizer=value)

    def getKerasOptimizer(self):
        return self.getOrDefault("kerasOptimizer")


class HasKerasLoss(Params):
    kerasLoss = Param("HasKerasLoss", "kerasLoss",
                      "loss name or callable(params_out, labels) -> scalar",
                      TypeConverters.toLoss)

    def setKerasLoss(self, value):
        return self._set(kerasLoss=value)

    def getKerasLoss(self):
        return self.getOrDefault("kerasLoss")
