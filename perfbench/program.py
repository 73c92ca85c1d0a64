"""What the benchmark takes from the program under test
(``sparkdl_tpu_torch``): its weight cache, its model functions, and the
counters its layers keep. Nothing here is timed by itself."""

from __future__ import annotations

import os

from perfbench.weights import for_cell

# the registry counters the per-layer metrics read as deltas
COUNTERS = ("engine.busy_seconds", "device.run_seconds")
RUNNER_FIELDS = ("rows", "batches", "seconds", "bytes_staged")


def seed_weights(ctx):
    """The configuration's seeded weights on the run's device, stored in
    the program's weight cache (a directory of the run's own, named by
    ``SPARKDL_TPU_TORCH_MODEL_CACHE``) so the zoo loads them by its
    provenance cascade. Returns the state dict for the reference."""
    from sparkdl_tpu_torch.models.fetcher import CACHE_ENV, ModelFetcher
    cfg = ctx.cell.config
    state = for_cell(ctx.cell, ctx.seed, ctx.device)
    ModelFetcher(cache_dir=ctx.tmp).put(f"{cfg['model']}.pt", state)
    os.environ[CACHE_ENV] = ctx.tmp
    return state


def model_function(ctx):
    """The zoo's function for the configuration, wrapped for the mix's
    packed rows (K2 for ``yuv420``, K1 for ``rgb``)."""
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    cfg, mix = ctx.cell.config, ctx.cell.mix
    mf = zoo.getModelFunction(cfg["model"], featurize=cfg["featurize"],
                              device=ctx.device.type)
    return deviceResizeModel(mf, tuple(mix["src_hw"]),
                             packedFormat=mix["format"])


def counters(runner_metrics=None) -> dict:
    """The program's cumulative counters now."""
    from sparkdl_tpu_torch.obs import default_registry
    reg = default_registry()
    out = {c: reg.counter(c).value for c in COUNTERS}
    if runner_metrics is not None:
        out.update({f"runner.{k}": getattr(runner_metrics, k)
                    for k in RUNNER_FIELDS})
    return out


def delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}
