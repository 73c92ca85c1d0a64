"""Estimators and evaluators — counterpart of ``sparkdl_tpu/estimators``
for the transfer-learning flow (the Keras estimator is not ported
yet)."""

from sparkdl_tpu_torch.estimators.evaluators import (
    BinaryClassificationEvaluator,
    ClassificationEvaluator,
    LossEvaluator,
)
from sparkdl_tpu_torch.estimators.logistic_regression import (
    LogisticRegression,
    LogisticRegressionModel,
    from_jax_params,
)
from sparkdl_tpu_torch.params.pipeline import EmptyScoredFrameError

__all__ = [
    "LogisticRegression",
    "LogisticRegressionModel",
    "from_jax_params",
    "BinaryClassificationEvaluator",
    "ClassificationEvaluator",
    "LossEvaluator",
    "EmptyScoredFrameError",
]
