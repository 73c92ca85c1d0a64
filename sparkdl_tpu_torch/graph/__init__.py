"""Graph toolkit of the port — counterpart of ``sparkdl_tpu/graph``: the
:class:`ModelFunction` (a named-IO module on one device, frozen by
``torch.export``), ingestion (:class:`ModelIngest`, alias
``TFInputGraph``), the converter pieces and ``utils``."""

from sparkdl_tpu_torch.graph.function import ModelFunction  # noqa: F401
from sparkdl_tpu_torch.graph.ingest import ModelIngest, TFInputGraph  # noqa: F401
from sparkdl_tpu_torch.graph.pieces import (  # noqa: F401
    buildFlattener,
    buildSpImageConverter,
)
from sparkdl_tpu_torch.graph import utils  # noqa: F401
from sparkdl_tpu_torch.graph.utils import with_preprocessor  # noqa: F401

__all__ = [
    "ModelFunction",
    "ModelIngest",
    "TFInputGraph",
    "buildSpImageConverter",
    "buildFlattener",
    "utils",
    "with_preprocessor",
]
