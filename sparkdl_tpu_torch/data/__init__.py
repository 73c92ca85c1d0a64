"""Partitioned frames over numpy batches."""

from sparkdl_tpu_torch.data.frame import DataFrame, Source, Stage  # noqa: F401
