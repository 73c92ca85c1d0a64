"""The traced sub-window: ``torch.profiler`` over a steady stretch of
the measured window, the program's own spans armed beside it, and their
reduction to device intervals, busy time, the top device ops and the
card's idle gaps labelled by what the host was doing.

The profiler records the card's activity only. Recording every host op
as well slowed the host-bound passes of these cells 1.8 times, so the
card's idle share read 61% where it is about 30%; the program's spans
(``obs/trace.py``: ``source.load``, ``stage:<name>``, ``runner.run``,
``dispatch``, ...) say what the host was doing, at a few microseconds
a span.

The busy time is the union of the card's kernel and copy intervals
(overlapping intervals on two streams count once), the arithmetic of
the program's ``utils/profiling.py::device_busy``. Profiler times are
microseconds from the trace's start: a small kernel launched on the idle
card at a known ``time.perf_counter()`` ties them to the host clock the
spans use.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

TOP = 10


def warm_profiler():
    """One short profile, so the window's first start does not pay for
    the profiler's own initialisation."""
    with torch.profiler.profile(activities=_activities()):
        _anchor()
        _sync()


def _activities():
    if torch.cuda.is_available():
        return [torch.profiler.ProfilerActivity.CUDA]
    return [torch.profiler.ProfilerActivity.CPU]


def _anchor():
    """The sub-window's first device op."""
    if torch.cuda.is_available():
        torch.zeros(1, device="cuda").add_(1)


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class SubWindow:
    """``start()`` / ``stop()`` around whole units of work; ``reduce()``
    after the measured window has closed."""

    def __init__(self):
        from sparkdl_tpu_torch.obs import tracer
        self._tracer = tracer()
        self.prof = None
        self.t0 = self.t1 = 0.0

    def start(self):
        self._tracer.arm()
        self._tracer.clear()
        self.prof = torch.profiler.profile(activities=_activities())
        self.prof.start()
        _sync()
        self.t0 = time.perf_counter()
        _anchor()

    def stop(self):
        _sync()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.spans = self._tracer.spans()
        self._tracer.arm_from_env()

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def reduce(self) -> Tuple[List[tuple], float, dict]:
        """(device ops [(name, start s, end s)] inside the sub-window,
        busy seconds, breakdown)."""
        device = [(e.name, e.time_range.start, e.time_range.end)
                  for e in self.prof.events()
                  if "CUDA" in str(getattr(e, "device_type", ""))]
        ops = []
        if device:
            lo = min(start for _, start, _ in device)   # the anchor
            hi = lo + self.seconds * 1e6
            for name, start, end in device:
                start, end = max(start, lo), min(end, hi)
                if end > start:
                    ops.append((name, (start - lo) / 1e6,
                                (end - lo) / 1e6))
        ops.sort(key=lambda o: o[1])
        busy, gaps = union(ops, self.seconds)
        # a request's span covers its whole life, not what the host did
        spans = [(s.name, s.start - self.t0, s.end - self.t0)
                 for s in self.spans if s.lane != "request"]
        breakdown = {"device_ops": top_ops(ops),
                     "idle_gaps": label_gaps(gaps, spans)}
        return ops, busy, breakdown


def union(ops, window_s: float):
    """(busy seconds of the union of the intervals, the idle gaps
    [(start, end)] between them inside [0, window_s])."""
    busy, end, gaps = 0.0, 0.0, []
    for _, a, b in ops:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if window_s > end:
        gaps.append((end, window_s))
    return busy, gaps


def top_ops(ops) -> List[list]:
    """The device ops that took most time: [name, seconds]."""
    total: Dict[str, float] = {}
    for name, a, b in ops:
        total[name] = total.get(name, 0.0) + (b - a)
    best = sorted(total.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:120], seconds] for name, seconds in best]


class _Index:
    """Intervals [(name, start, end)] sorted by start, for the innermost
    interval that holds a moment: the latest-starting one whose end lies
    past it, found by walking back from the moment (at most ``WALK``
    intervals)."""

    WALK = 4096

    def __init__(self, intervals):
        self.items = sorted(intervals, key=lambda i: i[1])
        self.starts = [i[1] for i in self.items]

    def innermost(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - self.WALK, -1), -1):
            if self.items[j][2] > t:
                return self.items[j][0]
        return None


# gaps shorter than this are the launch gaps between queued kernels and
# are counted together
SHORT_GAP_S = 10e-6


def label_gaps(gaps, spans) -> List[list]:
    """Idle time on the card grouped by what the host was doing when each
    gap began: the program's innermost span then, else "host"; gaps under
    10 us together. [label with the gap count and the longest, total
    seconds], the largest totals first."""
    spans = _Index(spans)
    by: Dict[str, list] = {}
    for a, b in gaps:
        if b - a < SHORT_GAP_S:
            label = "gaps under 10 us"
        else:
            label = spans.innermost(a) or "host"
        entry = by.setdefault(label, [0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += b - a
        entry[2] = max(entry[2], b - a)
    best = sorted(by.items(), key=lambda kv: -kv[1][1])[:TOP]
    return [[f"{label[:80]} (gaps {n}, longest {longest!r} s)", total]
            for label, (n, total, longest) in best]
