"""The measured window of a batch cell: whole passes of one planned
frame (``collect()``), run until ``--seconds`` is reached. The window
ends when the last pass ends, so every image it counts was completed in
it. In a traced run the profiler covers whole passes from the second
one on, until ``trace_min_s`` of them is traced; the passes it does not
cover are timed apart (``Record.plain_s``), since the profiler slows a
pass of these host-paced cells.

Each run prints, per pass, its seconds and the process's CPU seconds
(all its threads) on standard error."""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from perfbench import check, program
from perfbench.harness import Record
from perfbench.trace import SubWindow, warm_profiler


@dataclasses.dataclass
class Batch:
    """A batch cell's program, built in set-up."""
    planned: object          # the planned frame (transform done)
    out_col: str
    rows: np.ndarray         # the rows the frame was made from
    metrics: object          # the transformer's RunnerMetrics
    state: dict              # the seeded weights, for the reference


@dataclasses.dataclass
class Measured:
    attempted: int
    failed: int
    metrics: dict
    outputs: List[np.ndarray]
    record: Optional[Record] = None
    breakdown: Optional[dict] = None


def _sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def warm(ctx, st: Batch):
    """One pass at the cell's own shapes (every kernel built, every
    buffer allocated); the profiler's start-up too in a traced run."""
    st.planned.collect()
    _sync(ctx)
    if ctx.trace:
        warm_profiler()


def measure(ctx, st: Batch) -> Measured:
    n = len(st.rows)
    outputs, spans, sub, before = [], [], None, None
    cpu = [time.process_time()]
    trace_min_s = float(ctx.cell.mix.get("trace_min_s", 2.0))
    t0 = time.perf_counter()
    while True:
        if ctx.trace and sub is None and len(outputs) == 1:
            sub = SubWindow()
            before = program.counters(st.metrics)
            sub.start()
        start = time.perf_counter()
        out = st.planned.collect()
        outputs.append(np.asarray(out[st.out_col]))
        spans.append((start, time.perf_counter(),
                      sub is not None and not sub.t1))
        cpu.append(time.process_time())
        if sub is not None and not sub.t1 and \
                time.perf_counter() - sub.t0 >= trace_min_s:
            sub.stop()
            after = program.counters(st.metrics)
        traced = not ctx.trace or (sub is not None and sub.t1)
        if traced and time.perf_counter() - t0 >= ctx.seconds:
            break
    _sync(ctx)
    window = time.perf_counter() - t0
    images = n * len(outputs)
    print("passes", len(spans), "seconds each",
          [round(b - a, 4) for a, b, _ in spans], file=sys.stderr)
    print("process cpu seconds each",
          np.diff(cpu).round(3).tolist(), file=sys.stderr)
    m = Measured(attempted=images, failed=0,
                 metrics={"images_per_s": images / window},
                 outputs=outputs)
    if sub is not None:
        ops, busy, m.breakdown = sub.reduce()
        d = program.delta(after, before)
        plain = [(a, b) for a, b, profiled in spans if not profiled]
        m.record = Record(
            window_s=sub.seconds, images=int(d["runner.rows"]),
            batches=int(d["runner.batches"]), counters=d,
            runner={k[len("runner."):]: v for k, v in d.items()
                    if k.startswith("runner.")},
            device_ops=ops, busy_s=busy, bench_dir=ctx.cell.bench_dir,
            plain_images=n * len(plain),
            plain_s=sum(b - a for a, b in plain))
    return m


def compare(ctx, st: Batch, m: Measured) -> dict:
    """Every row of every pass against the reference's row."""
    rows, state = st.rows, st.state
    st.planned = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check.reference_outputs(ctx.cell, state, rows, ctx.device)
    worst = max((float(check.row_errors(o, ref).max()) for o in m.outputs),
                default=float("inf"))
    return {"out_rel_err_max": worst}
