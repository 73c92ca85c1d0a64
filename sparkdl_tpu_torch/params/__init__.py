"""Param machinery and the shared param mixins of the port."""

from sparkdl_tpu_torch.params.base import (  # noqa: F401
    Param,
    Params,
    Transformer,
    TypeConverters,
    keyword_only,
)
from sparkdl_tpu_torch.params.shared import (  # noqa: F401
    HasBatchSize,
    HasDevice,
    HasDeviceResizeFrom,
    HasInputCol,
    HasInputMapping,
    HasModelFunction,
    HasOutputCol,
    HasOutputMapping,
    HasOutputMode,
    HasTFHParams,
)
