"""Model functions of the port."""

from sparkdl_tpu_torch.graph.function import (  # noqa: F401
    ModelFunction,
    with_preprocessor,
)
