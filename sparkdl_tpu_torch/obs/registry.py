"""Process-wide metrics registry — counterpart of
``sparkdl_tpu/obs/registry.py``: named counters, gauges and
reservoirs with one ``snapshot() -> dict``.

The port's hot paths record into :func:`default_registry` under the
JAX package's names: ``engine.busy_seconds`` and ``engine.retries``
(the engine), ``device.run_seconds`` (the batch runner),
``pipeline.*`` (the parallel host pipeline) and ``inputsvc.*`` (the
decode fleet and the snapshot store). Keys are dotted
``<lane>.<what>``.

Counters are monotonic accumulators (``add``); gauges are
last-write-wins levels (``set``, plus ``set_max`` for high-water
marks); reservoirs are bounded sliding windows of observations with
nearest-rank quantiles (``observe`` / ``quantile``). All three are
thread-safe; their locks drop when pickled and are made anew on
arrival, values travel. The registry is process-wide: a reader that
shares the process with other work reads differences of two
snapshots, never absolute values.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Dict, Union


class Counter:
    """Monotonic named accumulator."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def add(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    # locks do not pickle; values travel
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


class Gauge:
    """Last-write-wins named level (queue depth, cumulative totals
    published from per-object metrics)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def set_max(self, value: float) -> None:
        """High-water-mark update: keep the larger of current/new."""
        with self._lock:
            self.value = max(self.value, float(value))

    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


def nearest_rank(sorted_vals, q: float) -> float:
    """THE nearest-rank quantile over an ascending-sorted sequence —
    the one convention every latency readout in this repo shares
    (Reservoir quantiles and every reader of them), so two p99s of
    one window cannot drift onto different math. Raises on an empty sequence —
    callers own their "no observations" semantics."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    if not sorted_vals:
        raise ValueError("nearest_rank needs at least one value")
    last = len(sorted_vals) - 1
    return sorted_vals[
        min(last, max(0, math.ceil(q * len(sorted_vals)) - 1))]


#: default Reservoir window (observations) — enough for a stable p99
#: under sustained load without unbounded growth
DEFAULT_RESERVOIR_CAPACITY = 4096

#: retained worst-case exemplars per reservoir — a scraped p99 needs a
#: handful of traceable specimens, not a second latency log
EXEMPLAR_CAPACITY = 8


class Reservoir:
    """Bounded sliding window of observations with nearest-rank
    quantile readout (request latencies, batch fill samples). Keeps the
    most recent ``capacity`` observations; ``count`` stays the lifetime
    total so a snapshot distinguishes "few samples" from "few
    retained".

    **Exemplars**: ``observe(value, exemplar={...})`` additionally
    offers a small payload (a request_id + phase breakdown) for
    worst-case retention — the :data:`EXEMPLAR_CAPACITY` largest
    recent values keep theirs, so a scraped p99 resolves to an actual
    request/trace instead of an anonymous number. Retention is a hard
    bound: candidates not retained (and retained ones displaced or
    aged out of the observation window) count in
    ``exemplars_dropped`` — the cardinality guard made visible, never
    an unbounded side-log."""

    def __init__(self, name: str,
                 capacity: int = DEFAULT_RESERVOIR_CAPACITY):
        if capacity <= 0:
            raise ValueError(
                f"capacity must be positive, got {capacity}")
        self.name = name
        self.capacity = capacity
        self.count = 0
        self.exemplars_dropped = 0
        self._window: collections.deque = collections.deque(
            maxlen=capacity)
        # (value, lifetime seq, payload) — small (EXEMPLAR_CAPACITY),
        # scanned linearly per exemplar-carrying observe
        self._exemplars: list = []
        self._lock = threading.Lock()

    def observe(self, value: float, exemplar=None) -> None:
        with self._lock:
            self._window.append(float(value))
            self.count += 1
            if exemplar is not None:
                self._offer_exemplar(float(value), exemplar)

    def _offer_exemplar(self, value: float, payload) -> None:
        # holding self._lock. Age out exemplars whose observation left
        # the sliding window — a worst case from an hour ago must not
        # shadow the current tail
        horizon = self.count - self.capacity
        fresh = [e for e in self._exemplars if e[1] > horizon]
        self.exemplars_dropped += len(self._exemplars) - len(fresh)
        self._exemplars = fresh
        if len(self._exemplars) < EXEMPLAR_CAPACITY:
            self._exemplars.append((value, self.count, payload))
            return
        worst_idx = min(range(len(self._exemplars)),
                        key=lambda i: self._exemplars[i][0])
        if value > self._exemplars[worst_idx][0]:
            self._exemplars[worst_idx] = (value, self.count, payload)
        # either the displaced retained exemplar or the rejected
        # candidate — one payload was discarded by the bound
        self.exemplars_dropped += 1

    def exemplars(self) -> list:
        """The retained worst-case exemplars, largest value first:
        ``[{**payload, "value": v}, ...]`` (``value`` is reserved —
        the observed number always wins a payload collision). The
        window horizon applies HERE too: plain ``observe()`` calls
        advance the window without touching the exemplar list, and an
        hour-old specimen must not be reported as the current tail
        once its observation has left the window."""
        with self._lock:
            horizon = self.count - self.capacity
            fresh = [e for e in self._exemplars if e[1] > horizon]
            self.exemplars_dropped += len(self._exemplars) - len(fresh)
            self._exemplars = fresh
            items = sorted(fresh, reverse=True,
                           key=lambda e: (e[0], e[1]))
        out = []
        for value, _seq, payload in items:
            d = dict(payload)
            d["value"] = value
            out.append(d)
        return out

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the retained window; 0.0 when no
        observations have been recorded (a snapshot must never raise)."""
        return self.quantiles((q,))[0]

    def quantiles(self, qs) -> tuple:
        """Several nearest-rank quantiles from ONE sorted snapshot of
        the window — readout paths that want p50 AND p99 (every
        publish) must not pay two O(n log n) sorts."""
        for q in qs:
            if not 0.0 <= q <= 1.0:
                raise ValueError(
                    f"quantile must be in [0, 1], got {q}")
        with self._lock:
            vals = sorted(self._window)
        if not vals:
            return tuple(0.0 for _ in qs)
        return tuple(nearest_rank(vals, q) for q in qs)

    # locks do not pickle; the retained window and lifetime count travel
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


class MetricsRegistry:
    """Thread-safe name → Counter/Gauge/Reservoir table with one flat
    ``snapshot()``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge, Reservoir]] = {}

    def counter(self, name: str) -> Counter:
        """The counter registered under ``name`` (created on first
        use). A name is one kind forever — re-requesting it as a gauge
        raises instead of silently forking the metric."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Counter(name)
            elif not isinstance(m, Counter):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    "requested as Counter")
            return m

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Gauge(name)
            elif not isinstance(m, Gauge):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    "requested as Gauge")
            return m

    def reservoir(self, name: str,
                  capacity: int = DEFAULT_RESERVOIR_CAPACITY
                  ) -> Reservoir:
        """The reservoir registered under ``name`` (created on first
        use; ``capacity`` applies only at creation). Same
        one-kind-forever contract as counter/gauge."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Reservoir(name, capacity)
            elif not isinstance(m, Reservoir):
                raise TypeError(
                    f"metric {name!r} is a {type(m).__name__}, "
                    "requested as Reservoir")
            return m

    def metrics(self) -> list:
        """The registered metric objects, sorted by name — the
        kind-preserving readout (``snapshot()`` flattens kinds away;
        a renderer that
        needs them)."""
        with self._lock:
            return [self._metrics[name]
                    for name in sorted(self._metrics)]

    def snapshot(self) -> Dict[str, float]:
        """One flat {name: value} dict, sorted by name.
        Reservoirs flatten to ``<name>.count`` / ``.p50`` / ``.p99``
        derived keys so the snapshot stays one level deep."""
        with self._lock:
            metrics = [self._metrics[name]
                       for name in sorted(self._metrics)]
        out: Dict[str, float] = {}
        for m in metrics:
            if isinstance(m, Reservoir):
                # quantiles() takes the reservoir's own lock — computed
                # OUTSIDE the registry lock so a concurrent observe()
                # never waits on a snapshot render
                p50, p99 = m.quantiles((0.5, 0.99))
                out[f"{m.name}.count"] = float(m.count)
                out[f"{m.name}.p50"] = p50
                out[f"{m.name}.p99"] = p99
            else:
                out[m.name] = m.value
        return out

    def clear(self) -> None:
        """Drop every metric (test isolation)."""
        with self._lock:
            self._metrics.clear()

    # locks don't pickle; the metric objects carry their own
    # drop-and-recreate hooks, so values travel
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """THE process-wide registry the instrumented hot paths record
    into."""
    return _REGISTRY
