"""Observability for the port — counterpart of ``sparkdl_tpu/obs``, so
far its metrics registry (:mod:`sparkdl_tpu_torch.obs.registry`). The
JAX package's spans, watchdog, cross-process telemetry, ledger and
HTTP surface are not ported yet."""

from sparkdl_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    MetricsRegistry,
    Reservoir,
    default_registry,
    nearest_rank,
)

__all__ = [
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "Reservoir",
    "default_registry",
    "nearest_rank",
]
