"""sparkdl_tpu_torch — the PyTorch/CUDA port of sparkdl_tpu.

The same pipeline surface as ``sparkdl_tpu`` (``readImages`` →
``DeepImageFeaturizer`` or ``DeepImagePredictor`` over every model of the
zoo → a features or predictions column, and ``readImagesPacked`` →
``TensorTransformer`` over a device-resize model; the transfer-learning
flow ``Pipeline([DeepImageFeaturizer, LogisticRegression])`` with its
evaluators, ``CrossValidator`` / ``TrainValidationSplit`` and
``load_model``; the graph toolkit, ``ModelFunction`` composed, exported by
``torch.export`` and saved, ``ModelIngest`` / ``TFInputGraph``; the Keras
inference paths ``KerasTransformer``, ``KerasImageFileTransformer`` and
``registerKerasImageUDF``, whose Keras models are converted to torch
modules; the Keras estimator ``KerasImageFileEstimator``, which trains
a converted Keras model with its hyperparameter search), run by PyTorch on an NVIDIA GPU, with the JAX package's
hand-written TPU kernel and its
4:2:0 resize-and-colour op rewritten as CUDA kernels
(``ops/csrc/resize_normalize.cu``, ``ops/csrc/yuv420_resize_normalize.cu``).

The port imports torch, numpy and the standard library only: nothing of
JAX, flax, pyarrow or ``sparkdl_tpu``; keras only inside the functions
that read a Keras model. Every entry point that touches a
device takes ``device=None``, which means ``"cuda"``; without a card it
raises instead of falling back to the CPU, so a CPU run is always asked
for (``device="cpu"``).

Exports resolve lazily, so importing the package loads only what a
symbol needs.
"""

__version__ = "0.1.0"

_EXPORTS = {
    "imageSchema": ("sparkdl_tpu_torch.image.imageIO", "imageSchema"),
    "readImages": ("sparkdl_tpu_torch.image.imageIO", "readImages"),
    "readImagesPacked": ("sparkdl_tpu_torch.image.imageIO",
                         "readImagesPacked"),
    "DeepImageFeaturizer": ("sparkdl_tpu_torch.transformers.named_image",
                            "DeepImageFeaturizer"),
    "DeepImagePredictor": ("sparkdl_tpu_torch.transformers.named_image",
                           "DeepImagePredictor"),
    "ImageTransformer": ("sparkdl_tpu_torch.transformers.image_transform",
                         "ImageTransformer"),
    "TensorTransformer": ("sparkdl_tpu_torch.transformers.tensor_transform",
                          "TensorTransformer"),
    # reference-era aliases (TFImageTransformer / TFTransformer)
    "TFImageTransformer": ("sparkdl_tpu_torch.transformers.image_transform",
                           "ImageTransformer"),
    "TFTransformer": ("sparkdl_tpu_torch.transformers.tensor_transform",
                      "TensorTransformer"),
    "KerasImageFileTransformer": (
        "sparkdl_tpu_torch.transformers.keras_image",
        "KerasImageFileTransformer"),
    "KerasTransformer": ("sparkdl_tpu_torch.transformers.keras_tensor",
                         "KerasTransformer"),
    "ModelIngest": ("sparkdl_tpu_torch.graph.ingest", "ModelIngest"),
    "TFInputGraph": ("sparkdl_tpu_torch.graph.ingest", "TFInputGraph"),
    "registerKerasImageUDF": ("sparkdl_tpu_torch.udf.keras_image_model",
                              "registerKerasImageUDF"),
    "DataFrame": ("sparkdl_tpu_torch.data.frame", "DataFrame"),
    "LogisticRegression": ("sparkdl_tpu_torch.estimators.logistic_regression",
                           "LogisticRegression"),
    "KerasImageFileEstimator": (
        "sparkdl_tpu_torch.estimators.keras_image_file_estimator",
        "KerasImageFileEstimator"),
    "Pipeline": ("sparkdl_tpu_torch.params.pipeline", "Pipeline"),
    "CrossValidator": ("sparkdl_tpu_torch.params.tuning", "CrossValidator"),
    "TrainValidationSplit": ("sparkdl_tpu_torch.params.tuning",
                             "TrainValidationSplit"),
    "ParamGridBuilder": ("sparkdl_tpu_torch.params.tuning",
                         "ParamGridBuilder"),
    "ClassificationEvaluator": ("sparkdl_tpu_torch.estimators.evaluators",
                                "ClassificationEvaluator"),
    "BinaryClassificationEvaluator": (
        "sparkdl_tpu_torch.estimators.evaluators",
        "BinaryClassificationEvaluator"),
    "LossEvaluator": ("sparkdl_tpu_torch.estimators.evaluators",
                      "LossEvaluator"),
    "load_model": ("sparkdl_tpu_torch.params.persistence", "load_stage"),
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'sparkdl_tpu_torch' has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
