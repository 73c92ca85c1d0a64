"""Param machinery, the pipeline and tuning stages, and the shared param
mixins of the port."""

from sparkdl_tpu_torch.params.base import (  # noqa: F401
    Param,
    Params,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.params.pipeline import (  # noqa: F401
    EmptyScoredFrameError,
    Estimator,
    Evaluator,
    Model,
    Pipeline,
    PipelineModel,
    Transformer,
)
from sparkdl_tpu_torch.params.tuning import (  # noqa: F401
    CrossValidator,
    CrossValidatorModel,
    ParamGridBuilder,
    TrainValidationSplit,
    TrainValidationSplitModel,
)
from sparkdl_tpu_torch.params.shared import (  # noqa: F401
    HasBatchSize,
    HasDevice,
    HasDeviceResizeFrom,
    HasInputCol,
    HasInputMapping,
    HasKerasLoss,
    HasKerasModel,
    HasKerasOptimizer,
    HasLabelCol,
    HasModelFunction,
    HasOutputCol,
    HasOutputMapping,
    HasOutputMode,
    HasTFHParams,
    HasUseMesh,
)
from sparkdl_tpu_torch.params.image import CanLoadImage  # noqa: F401
