"""Estimators and evaluators — counterpart of ``sparkdl_tpu/estimators``:
the Keras estimator (``KerasImageFileEstimator``, training a converted
Keras model), the transfer-learning flow's ``LogisticRegression`` and
the evaluators."""

from sparkdl_tpu_torch.estimators.evaluators import (
    BinaryClassificationEvaluator,
    ClassificationEvaluator,
    LossEvaluator,
)
from sparkdl_tpu_torch.estimators.keras_image_file_estimator import (
    KerasImageFileEstimator,
    KerasImageFileModel,
)
from sparkdl_tpu_torch.estimators.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
    from_jax_params,
)
from sparkdl_tpu_torch.params.pipeline import EmptyScoredFrameError

__all__ = [
    "KerasImageFileEstimator",
    "KerasImageFileModel",
    "LogisticRegression",
    "LogisticRegressionModel",
    "from_jax_params",
    "BinaryClassificationEvaluator",
    "ClassificationEvaluator",
    "LossEvaluator",
    "EmptyScoredFrameError",
]
