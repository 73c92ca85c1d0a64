"""Per-partition batch runner — counterpart of
``sparkdl_tpu/runtime/runner.py`` (``BatchRunner`` with its four
transfer strategies and the device-resident infeed ring).

A partition's rows arrive as host arrays and are cut into fixed-size
device chunks (the model always sees one batch shape: the last chunk is
zero-padded and its outputs truncated), run on the model's device, and
gathered back into one preallocated ``[N, *out]`` host slab per output.

Transfer strategies (``SPARKDL_TPU_RUNNER_STRATEGY`` or the
``strategy`` argument; ``deferred`` by default), on the card:

* ``immediate`` — per chunk: stage, copy to the device, run, and copy
  the result back, waiting for it before the next chunk.
* ``deferred`` — enqueue up to ``max_inflight`` chunks (default 2)
  before draining the oldest, so the host stages chunk *i+1* while the
  device computes chunk *i*. A drain copies its chunk back on the
  runner's copy-back stream once that chunk's compute event has fired,
  so it waits for its own chunk, not for the chunks queued behind it.
* ``host_async`` — as ``deferred`` (default depth 8), and each chunk's
  device→host copy starts at enqueue: a ``non_blocking`` copy on the
  copy-back stream, after the compute stream's event, into the chunk's
  rows of a pinned output slab; the drain waits on that copy's event.
* ``prefetch`` — as ``host_async``, and the next ``prefetch_depth``
  chunks (``SPARKDL_TPU_PREFETCH_DEPTH``, default 1) are copied to the
  device on the runner's copy-in stream ahead of their compute; the
  compute stream waits on each chunk's event.

The compute stream is the caller's current stream on the model's
device, the same for every chunk of a run (kernel K2's work queue is
kept per stream). Tensors made on one stream and read on another are
marked with ``record_stream``, so the caching allocator does not hand
their memory out while the other stream still reads it.

Host→device staging. Every chunk's rows are written into a pinned
staging buffer (the tail zero-padded) and copied with
``non_blocking=True``; the buffers form a ring of ``max_inflight +
prefetch_depth + 1`` slots, each guarded by the event recorded after
its copy, and the host waits on that event before it writes the slot
again. The rows are written with torch's copy, which runs on its
intra-op threads. The alternative, a copy straight from the caller's
pageable array, holds the host for the whole transfer (CUDA stages
pageable memory through its own buffers), and longer behind a queued
model call. ``chip_smoke.py``'s ``runner_split`` phase times both on one
chunk of 64×512×512×3 uint8; on an H100 80GB HBM3 (700 W) the threaded
copy into pinned memory took 1.6 ms and its async transfer 1.1 ms,
against 4.1 ms of host held by the pageable copy alone and 11 ms behind
a queued model call, so the pinned ring is kept.
``RunnerMetrics.bytes_staged`` counts the bytes the port really
stages: every chunk on the card; on the CPU, where a full contiguous
chunk is used as a view, only the padded tail, as the JAX runner
counts.

On top of any strategy, an optional **infeed ring**
(``SPARKDL_TPU_INFEED_RING`` / ``infeed_ring``, K >= 2) keeps the last
K placed chunks resident on the device, content-addressed: a chunk
whose bytes (blake2b-128 over names, dtypes, shape and rows) sit in a
live slot runs on the resident tensors and ships nothing. A miss with a
free or stale slot is retained; a miss while every slot is recently
useful streams through: the runner keeps no reference to the chunk's
device inputs once the model call is enqueued, so the stream-ordered
caching allocator hands that memory to the next allocations on the
compute stream instead of the ring holding it — torch has no donation;
this is its counterpart, counted as ``donated``.
Shipping content that crossed before is counted in
``ShipStats.reshipped_bytes``.

On the CPU (``device="cpu"``) every strategy runs the same queue,
staging and slab bookkeeping, with no stream or event operations.
``strategy``, ``max_inflight``, ``prefetch_depth`` and ``infeed_ring``
are read afresh at every ``run()``. Left for later: multi-device
placement (``interleaved_device_put``, ``ShardedBatchRunner``) and the
autotune, ledger, watchdog, compile-log and sanitize hooks.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.obs import default_registry
from sparkdl_tpu_torch.resilience.faults import maybe_fail

# In-flight chunks before the oldest result is drained, for "deferred":
# 2 = double-buffering (one executing, one queued behind it).
MAX_INFLIGHT_BATCHES = 2
# host_async keeps a deeper queue: its entries' device→host copies are
# already in flight, so draining old entries is cheap; prefetch shares it
MAX_INFLIGHT_HOST_ASYNC = 8
# default input look-ahead of the "prefetch" strategy
DEFAULT_PREFETCH_DEPTH = 1
# infeed ring depth: 0 = off; once engaged the floor is K=2
DEFAULT_INFEED_RING = 0

_STRATEGIES = ("immediate", "deferred", "host_async", "prefetch")

logger = logging.getLogger(__name__)


def _default_strategy() -> str:
    env = os.environ.get("SPARKDL_TPU_RUNNER_STRATEGY")
    if env:
        if env not in _STRATEGIES:
            raise ValueError(
                f"SPARKDL_TPU_RUNNER_STRATEGY must be one of "
                f"{_STRATEGIES}, got {env!r}")
        return env
    return "deferred"


def resolve_strategy(strategy: Optional[str],
                     max_inflight: Optional[int]) -> Tuple[str, int]:
    """Validate/default the (strategy, max_inflight) pair.

    An explicit positive ``max_inflight`` with no explicit strategy
    means the caller wants a queue — that selects ``deferred``;
    combining it with an explicit ``strategy='immediate'`` is a
    contradiction and raises."""
    if strategy is None and max_inflight is not None \
            and not os.environ.get("SPARKDL_TPU_RUNNER_STRATEGY"):
        # (an explicit env strategy still wins — a contradiction with
        # max_inflight then errors below, loudly)
        strategy = "deferred" if max_inflight > 0 else "immediate"
    strategy = strategy or _default_strategy()
    if strategy not in _STRATEGIES:
        raise ValueError(
            f"strategy must be one of {_STRATEGIES}, got {strategy!r}")
    if strategy == "immediate":
        if max_inflight is not None and max_inflight > 0:
            raise ValueError(
                f"strategy='immediate' means a zero-length queue; "
                f"max_inflight={max_inflight} contradicts it (use "
                "strategy='deferred' for a bounded queue)")
        return strategy, 0
    if max_inflight is not None:
        return strategy, max_inflight
    return strategy, (MAX_INFLIGHT_HOST_ASYNC
                      if strategy in ("host_async", "prefetch")
                      else MAX_INFLIGHT_BATCHES)


def resolve_prefetch_depth(depth: Optional[int]) -> int:
    """Validate/default the "prefetch" strategy's input look-ahead: an
    explicit value wins, then ``SPARKDL_TPU_PREFETCH_DEPTH``, then
    :data:`DEFAULT_PREFETCH_DEPTH`."""
    if depth is None:
        env = os.environ.get("SPARKDL_TPU_PREFETCH_DEPTH")
        if not env:
            return DEFAULT_PREFETCH_DEPTH
        try:
            depth = int(env)
        except ValueError:
            raise ValueError(
                f"SPARKDL_TPU_PREFETCH_DEPTH must be a positive int, "
                f"got {env!r}") from None
    if depth < 1:
        raise ValueError(f"prefetch_depth must be >= 1, got {depth}")
    return int(depth)


#: ring config values that degraded to a working shape (a typo, a
#: negative depth, a depth of 1), process-wide
ring_config_errors = 0


def _ring_config_error(reason: str, msg: str, *args) -> None:
    global ring_config_errors
    ring_config_errors += 1
    warn_once(reason, msg, *args)


def _ring_env_int(name: str, default: int) -> int:
    """Integer env knob of the ring that degrades on a typo instead of
    raising: the ring is a performance layer a bad env var must not
    take the pipeline down with (loudly: :func:`warn_once` and
    :data:`ring_config_errors`)."""
    env = os.environ.get(name)
    if env is None or env == "":
        return default
    try:
        return int(env)
    except ValueError:
        _ring_config_error(f"config:{name}",
                           "%s must be an integer, got %r; running with "
                           "the default %d", name, env, default)
        return default


def resolve_infeed_ring(depth: Optional[int]) -> int:
    """Validate/default the infeed ring depth: 0 is off, K >= 2 engages
    a K-slot :class:`InfeedRing`. An explicit value wins, then
    ``SPARKDL_TPU_INFEED_RING``, then :data:`DEFAULT_INFEED_RING`.
    Negatives fall back to the default and 1 clamps up to 2, loudly."""
    if depth is None:
        depth = _ring_env_int("SPARKDL_TPU_INFEED_RING",
                              DEFAULT_INFEED_RING)
    depth = int(depth)
    if depth < 0:
        _ring_config_error("config:infeed_ring_negative",
                           "infeed_ring %d is negative; ring stays off",
                           depth)
        return DEFAULT_INFEED_RING
    if depth == 1:
        _ring_config_error("config:infeed_ring_floor",
                           "infeed_ring 1 cannot double-buffer (a 1-slot "
                           "ring evicts on every miss); clamped up to the "
                           "K=2 floor")
        return 2
    return depth


_WARNED_REASONS: set = set()


def warn_once(reason: str, msg: str, *args) -> None:
    """Log ``msg`` at WARNING exactly once per process per ``reason``."""
    if reason in _WARNED_REASONS:
        return
    _WARNED_REASONS.add(reason)
    logger.warning(msg, *args)


def check_row_counts(inputs: Dict[str, np.ndarray]) -> int:
    """Validate equal leading dims across named inputs; returns N."""
    names = list(inputs)
    if not names:
        raise ValueError("no inputs")
    n = len(inputs[names[0]])
    for k, v in inputs.items():
        if len(v) != n:
            raise ValueError(f"input {k!r} has {len(v)} rows, expected {n}")
    return n


def check_against_signature(inputs: Dict[str, np.ndarray],
                            model_fn: ModelFunction) -> None:
    """Every declared model input must be present with the declared
    per-row shape and dtype."""
    missing = [k for k in model_fn.input_signature if k not in inputs]
    if missing:
        raise ValueError(
            f"model {model_fn.name!r} inputs {missing} missing from "
            f"runner inputs {sorted(inputs)}")
    for k, (shape, dtype) in model_fn.input_signature.items():
        got = tuple(np.shape(inputs[k])[1:])
        if got != tuple(shape):
            raise ValueError(
                f"input {k!r} rows have shape {got}; model "
                f"{model_fn.name!r} expects {tuple(shape)}")
        if np.asarray(inputs[k]).dtype != np.dtype(dtype):
            raise ValueError(
                f"input {k!r} has dtype {np.asarray(inputs[k]).dtype}; "
                f"model {model_fn.name!r} expects {np.dtype(dtype)}")


@dataclass
class CopyCounters:
    """Per-call host-copy accounting, folded into RunnerMetrics.
    ``bytes_staged``: input rows written into a staging buffer.
    ``bytes_copied``: input bytes of rows that were not contiguous in
    the caller's array."""

    bytes_staged: int = 0
    bytes_copied: int = 0


def _count(counters: Optional[CopyCounters], rows: np.ndarray,
           staged: bool) -> None:
    if counters is None:
        return
    if staged:
        counters.bytes_staged += rows.nbytes
    if not rows.flags.c_contiguous:
        counters.bytes_copied += rows.nbytes


class PadStaging:
    """The CPU path's persistent staging buffer for the padded tail chunk,
    one per input name, reused across ``run()`` calls (the JAX runner's
    ``PadStaging``). Reuse is safe: a run drains every result before it
    returns and stages the tail at most once."""

    def __init__(self):
        self._bufs: Dict[str, np.ndarray] = {}

    def stage(self, name: str, rows: np.ndarray, chunk_size: int,
              counters: Optional[CopyCounters] = None) -> np.ndarray:
        """Copy ``rows`` into the ``[chunk_size, *row]`` buffer for
        ``name``, zero the pad region, return the buffer."""
        shape = (chunk_size,) + rows.shape[1:]
        buf = self._bufs.get(name)
        if buf is None or buf.shape != shape or buf.dtype != rows.dtype:
            buf = self._bufs[name] = np.zeros(shape, rows.dtype)
        valid = len(rows)
        buf[:valid] = rows
        if valid < chunk_size:
            buf[valid:] = 0
        _count(counters, rows, staged=True)
        return buf


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class PinnedStaging:
    """The card's staging ring: slots of pinned ``[chunk_size, *row]``
    buffers, one per input name, each guarded by the event recorded
    after the host→device copy that read it. A slot is written again
    only after its event has fired, so rows of a later chunk never
    overwrite rows still being copied. Slots are made on demand up to
    the ring's size (pinned memory is slow to allocate; torch's caching
    host allocator keeps freed blocks for the next runner)."""

    def __init__(self):
        self._slots: List[Dict[str, torch.Tensor]] = []
        self._events: List[Optional[torch.cuda.Event]] = []
        self._next = 0

    def checkout(self, size: int) -> int:
        """A free slot's index: a fired one, else a new one while the
        ring has fewer than ``size``, else the next in turn, after
        waiting on its event."""
        for i, ev in enumerate(self._events):
            if ev is None or ev.query():
                return i
        if len(self._slots) < size:
            self._slots.append({})
            self._events.append(None)
            return len(self._slots) - 1
        i = self._next % len(self._slots)
        self._next += 1
        self._events[i].synchronize()
        return i

    def stage(self, slot: int, name: str, rows: np.ndarray,
              chunk_size: int, counters: Optional[CopyCounters] = None
              ) -> torch.Tensor:
        shape = (chunk_size,) + rows.shape[1:]
        dtype = _torch_dtype(rows.dtype)
        buf = self._slots[slot].get(name)
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            buf = self._slots[slot][name] = torch.empty(
                shape, dtype=dtype, pin_memory=True)
        valid = len(rows)
        if rows.flags.c_contiguous and rows.flags.writeable:
            # torch's copy runs on its intra-op threads; numpy's on one
            buf[:valid].copy_(torch.from_numpy(rows))
        else:
            buf.numpy()[:valid] = rows
        if valid < chunk_size:
            buf[valid:].zero_()
        _count(counters, rows, staged=True)
        return buf

    def guard(self, slot: int, event: torch.cuda.Event) -> None:
        self._events[slot] = event


def checkout_staging(staging, lock: threading.Lock):
    """(stager, locked): the persistent stager when uncontended, else a
    private throwaway — concurrent run() calls on one runner must not
    race on shared buffers; release the lock iff ``locked``."""
    if lock.acquire(blocking=False):
        return staging, True
    return type(staging)(), False


def iter_padded_chunks(inputs: Dict[str, np.ndarray], n: int,
                       chunk_size: int,
                       staging: Optional[PadStaging] = None,
                       counters: Optional[CopyCounters] = None,
                       pad: bool = True
                       ) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """Cut [N, ...] host arrays into chunks of ``chunk_size`` rows.
    Yields ``(n_valid, chunk)``.

    ``pad=True`` (the CPU path, the JAX runner's behaviour): full
    contiguous chunks are views, non-contiguous ones copies (counted in
    ``bytes_copied``), and the tail is staged zero-padded through
    ``staging``. ``pad=False`` (the card): each chunk is its valid rows
    as views; placement stages and pads them in pinned memory."""
    if pad and staging is None:
        staging = PadStaging()
    for lo in range(0, n, chunk_size):
        hi = min(lo + chunk_size, n)
        chunk = {}
        for k, v in inputs.items():
            rows = v[lo:hi]
            if not pad:
                chunk[k] = rows
            elif hi - lo < chunk_size:
                chunk[k] = staging.stage(k, rows, chunk_size, counters)
            elif rows.flags.c_contiguous:
                chunk[k] = rows
            else:
                # a fresh copy per full chunk, not a shared buffer:
                # several full chunks may be in flight at once
                chunk[k] = np.ascontiguousarray(rows)
                _count(counters, rows, staged=False)
        yield hi - lo, chunk


@dataclass
class Placed:
    """One chunk's inputs on the model's device: the tensors, the event
    their host→device copy recorded (None when they were made on the
    compute stream, or on the CPU), and whether they were made on the
    copy-in stream (then each compute use is ``record_stream``-ed)."""

    tensors: Dict[str, torch.Tensor]
    ready: Optional[torch.cuda.Event] = None
    side_stream: bool = False


class _Transfer:
    """One run's transfer plumbing on one device: the compute stream
    (the caller's current one), the runner's copy-in and copy-back
    streams and its staging. On the CPU there are no streams: placement
    is ``torch.from_numpy`` of the padded chunk."""

    def __init__(self, device: torch.device, chunk_size: int,
                 staging, slots: int, streams=None):
        self.device = device
        self.cuda = device.type == "cuda"
        self.chunk_size = chunk_size
        self.staging = staging
        self.slots = slots
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.h2d, self.d2h = streams

    def place(self, valid: int, chunk: Dict[str, np.ndarray],
              counters: Optional[CopyCounters], ahead: bool = False,
              own: bool = False) -> Placed:
        """Put one chunk on the device. On the card: stage its rows in a
        pinned slot and copy them, on the copy-in stream when ``ahead``
        (prefetch) else on the compute stream. On the CPU: views of the
        padded chunk, copied when ``own`` (a ring slot must own its
        bytes: the caller may rewrite its arrays)."""
        if not self.cuda:
            return Placed({k: torch.from_numpy(np.array(v) if own else v)
                           for k, v in chunk.items()})
        slot = self.staging.checkout(self.slots)
        stream = self.h2d if ahead else self.compute
        with torch.cuda.stream(stream):
            tensors = {}
            for k, rows in chunk.items():
                host = self.staging.stage(slot, k, rows, self.chunk_size,
                                          counters)
                dev = torch.empty(host.shape, dtype=host.dtype,
                                  device=self.device)
                dev.copy_(host, non_blocking=True)
                tensors[k] = dev
            ready = torch.cuda.Event()
            ready.record(stream)
        self.staging.guard(slot, ready)
        return Placed(tensors, ready if ahead else None, ahead)

    def run(self, model_fn: ModelFunction, placed: Placed):
        """Enqueue the model on the compute stream; returns its outputs
        and the event recorded after them (None on the CPU)."""
        if not self.cuda:
            return model_fn.apply(placed.tensors), None
        if placed.ready is not None:
            self.compute.wait_event(placed.ready)
        if placed.side_stream:
            for t in placed.tensors.values():
                t.record_stream(self.compute)
        out = model_fn.apply(placed.tensors)
        done = torch.cuda.Event()
        done.record(self.compute)
        return out, done


class SlabSink:
    """Preallocated ``[N, *out]`` outputs, written in place chunk by
    chunk, in dispatch order. The slabs are made from the first chunk's
    outputs; pinned when ``pinned`` (host_async, prefetch: a copy into
    pageable memory would not overlap anything). ``transfer_wait``
    accumulates time blocked waiting for results."""

    def __init__(self, n: int, names: List[str], pinned: bool = False):
        self.n = n
        self.names = names
        self.pinned = pinned
        self.transfer_wait = 0.0
        self._row = 0
        self._slabs: Optional[Dict[str, torch.Tensor]] = None

    def reserve(self, valid: int, out: Dict[str, torch.Tensor]) -> int:
        """The first slab row of the next chunk's ``valid`` rows."""
        if self._slabs is None:
            self._slabs = {
                k: torch.empty((self.n,) + tuple(out[k].shape[1:]),
                               dtype=out[k].dtype, pin_memory=self.pinned)
                for k in self.names}
        lo = self._row
        self._row += valid
        return lo

    def start(self, xfer: _Transfer, valid: int,
              out: Dict[str, torch.Tensor], done) -> Optional[object]:
        """host_async's enqueue hook (:func:`start_host_copies`)."""
        lo = self.reserve(valid, out)
        if not xfer.cuda:
            for k in self.names:
                self._slabs[k][lo:lo + valid].copy_(out[k][:valid])
            return None
        xfer.d2h.wait_event(done)
        with torch.cuda.stream(xfer.d2h):
            for k in self.names:
                out[k].record_stream(xfer.d2h)
                self._slabs[k][lo:lo + valid].copy_(out[k][:valid],
                                                    non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(xfer.d2h)
        return copied

    def write(self, xfer: _Transfer, valid: int,
              out: Dict[str, torch.Tensor], done) -> None:
        """A blocking copy of one chunk's valid rows (immediate and
        deferred drains): on the copy-back stream after the chunk's
        compute event, so it waits for that chunk only."""
        t0 = time.perf_counter()
        lo = self.reserve(valid, out)
        if not xfer.cuda:
            for k in self.names:
                self._slabs[k][lo:lo + valid].copy_(out[k][:valid])
        else:
            xfer.d2h.wait_event(done)
            with torch.cuda.stream(xfer.d2h):
                for k in self.names:
                    out[k].record_stream(xfer.d2h)
                    self._slabs[k][lo:lo + valid].copy_(out[k][:valid])
        self.transfer_wait += time.perf_counter() - t0

    def wait(self, copied) -> None:
        t0 = time.perf_counter()
        if copied is not None:
            copied.synchronize()
        self.transfer_wait += time.perf_counter() - t0

    def result(self) -> Dict[str, np.ndarray]:
        assert self._row == self.n and self._slabs is not None, \
            (self._row, self.n)
        return {k: v.numpy() for k, v in self._slabs.items()}


def start_host_copies(sink: SlabSink, xfer: _Transfer, valid: int,
                      out, done):
    """Start one chunk's device→host copy at enqueue (host_async,
    prefetch): returns the pending entry its drain waits on."""
    return ("copy", valid, sink.start(xfer, valid, out, done))


def start_device_prefetch(xfer: _Transfer, valid: int, chunk,
                          counters: Optional[CopyCounters],
                          own: bool = False) -> Placed:
    """Place an upcoming chunk on the copy-in stream so its host→device
    copy overlaps the current chunk's compute (the prefetch strategy's
    input hook)."""
    return xfer.place(valid, chunk, counters, ahead=True, own=own)


def dispatch_donated(model_fn: ModelFunction, xfer: _Transfer,
                     placed: Placed):
    """Run one ring stream-through chunk and drop the runner's last
    reference to its device inputs as soon as the call is enqueued, so
    the stream-ordered allocator can reuse their memory for the next
    allocations on the compute stream (the counterpart of the JAX
    runner's donated dispatch)."""
    tensors = placed.tensors
    placed.tensors = {}
    return xfer.run(model_fn, Placed(tensors, placed.ready,
                                     placed.side_stream))


def drain_bounded(pending: "collections.deque", sink: SlabSink,
                  xfer: _Transfer, limit: int):
    """Drain completed chunks into the output slab until at most
    ``limit`` remain enqueued (the backpressure half of async
    dispatch)."""
    while len(pending) > limit:
        maybe_fail("ship.drain")
        entry = pending.popleft()
        if entry[0] == "copy":
            sink.wait(entry[2])
        else:
            _, valid, out, done = entry
            sink.write(xfer, valid, out, done)


@dataclass
class _RingSlot:
    """One retained ring slab: its fingerprint, the placed chunk, and
    the bookkeeping the hit/evict policy runs on."""

    fp: bytes
    placed: Placed
    nbytes: int
    hits: int = 0
    last_used: int = 0


class InfeedRing:
    """Device-resident infeed ring: K content-addressed placed chunks,
    kept per runner across ``run()`` calls. Policy, per chunk:

    * **hit** — the chunk's fingerprint matches a live slot: the
      resident tensors run, and no byte crosses to the device;
    * **miss, slot available** — the placed chunk is retained: empty
      capacity first, then a stale slot (no hit or refresh for
      >= 2*depth dispatches);
    * **miss, every slot recently useful** — the chunk streams through
      (:func:`dispatch_donated`); the hot resident set is never evicted
      for one-shot traffic.

    ``note_shipped`` keeps a bounded fingerprint history of everything
    that crossed, so shipping the same content twice is counted. Used
    by one run at a time: a runner checks its ring out under a
    try-lock, and a concurrent ``run()`` ships normally."""

    def __init__(self, depth: int):
        if depth < 2:
            raise ValueError(f"ring depth must be >= 2, got {depth}")
        self.depth = int(depth)
        self._slots: List[_RingSlot] = []
        self._index: Dict[bytes, int] = {}
        self._shipped: "collections.OrderedDict[bytes, None]" = \
            collections.OrderedDict()
        self._clock = 0
        self._victim = 0

    def fingerprint(self, chunk: Dict[str, np.ndarray], valid: int,
                    chunk_size: int) -> bytes:
        """Content address of one host chunk: the names, dtypes, chunk
        shape and the bytes of its ``valid`` rows (the pad rows are
        zeros by construction), blake2b-128."""
        h = hashlib.blake2b(digest_size=16)
        h.update(str((valid, chunk_size)).encode())
        for k in sorted(chunk):
            v = np.asarray(chunk[k])[:valid]
            if not v.flags.c_contiguous:
                v = np.ascontiguousarray(v)
            h.update(k.encode())
            h.update(str(v.dtype).encode())
            h.update(str(v.shape[1:]).encode())
            h.update(v)
        return h.digest()

    def tick(self) -> None:
        """One dispatch observed — the idle-age clock evictions key on."""
        self._clock += 1

    def get(self, fp: bytes) -> Optional[Placed]:
        """The resident chunk for ``fp``, or None."""
        i = self._index.get(fp)
        if i is None:
            return None
        slot = self._slots[i]
        slot.hits += 1
        slot.last_used = self._clock
        return slot.placed

    def note_shipped(self, fp: bytes) -> bool:
        """Record ``fp`` as having crossed; True when it had already."""
        seen = fp in self._shipped
        self._shipped[fp] = None
        if seen:
            self._shipped.move_to_end(fp)
        cap = max(64, 8 * self.depth)
        while len(self._shipped) > cap:
            self._shipped.popitem(last=False)
        return seen

    def admit(self, fp: bytes, placed: Placed, nbytes: int) -> bool:
        """Try to retain a just-placed chunk: True = retained; False =
        every slot is recently useful, stream the chunk through."""
        if len(self._slots) < self.depth:
            self._index[fp] = len(self._slots)
            self._slots.append(_RingSlot(fp, placed, nbytes,
                                         last_used=self._clock))
            return True
        for off in range(self.depth):
            i = (self._victim + off) % self.depth
            if self._clock - self._slots[i].last_used >= 2 * self.depth:
                self._victim = (i + 1) % self.depth
                self._index.pop(self._slots[i].fp, None)
                self._slots[i] = _RingSlot(fp, placed, nbytes,
                                           last_used=self._clock)
                self._index[fp] = i
                return True
        return False

    def retire_all(self) -> None:
        """Back-date every slot so each is immediately reclaimable (after
        warmup fills the ring with synthetic chunks that will never hit);
        the slots still serve hits until evicted."""
        for slot in self._slots:
            slot.last_used = self._clock - 2 * self.depth

    def resize(self, depth: int) -> None:
        """Adopt a new depth between runs: shrinking drops the highest
        slots; growing keeps every resident chunk."""
        depth = int(depth)
        if depth < 2:
            raise ValueError(f"ring depth must be >= 2, got {depth}")
        if depth == self.depth:
            return
        if depth < len(self._slots):
            del self._slots[depth:]
            self._index = {s.fp: i for i, s in enumerate(self._slots)}
        self.depth = depth
        self._victim = 0

    def state(self) -> dict:
        return {
            "depth": int(self.depth),
            "slots": len(self._slots),
            "resident_bytes": int(sum(s.nbytes for s in self._slots)),
            "hits": int(sum(s.hits for s in self._slots)),
        }


@dataclass
class ShipStats:
    """Ring accounting of a run (or, on the runner, of all its runs):
    bytes that crossed to the device, bytes served by resident chunks,
    hits, misses, stream-through chunks (``donated``) and bytes that
    crossed a second time (``reshipped_bytes``)."""

    shipped_bytes: int = 0
    resident_bytes: int = 0
    hits: int = 0
    misses: int = 0
    donated: int = 0
    reshipped_bytes: int = 0

    def add(self, other: "ShipStats") -> None:
        for f in ("shipped_bytes", "resident_bytes", "hits", "misses",
                  "donated", "reshipped_bytes"):
            setattr(self, f, getattr(self, f) + getattr(other, f))


@dataclass
class ChunkPhases:
    """Per-run phase times, accumulated by :func:`dispatch_chunks` when
    a caller hands one in: placement (``device_put_s``), model enqueue
    (``enqueue_s``) and the drain waits (``drain_s``)."""

    device_put_s: float = 0.0
    enqueue_s: float = 0.0
    drain_s: float = 0.0


def dispatch_chunks(model_fn: ModelFunction, chunks, strategy: str,
                    max_inflight: int, sink: SlabSink, xfer: _Transfer,
                    counters: Optional[CopyCounters] = None,
                    prefetch_depth: int = DEFAULT_PREFETCH_DEPTH,
                    phases: Optional[ChunkPhases] = None,
                    ring: Optional[InfeedRing] = None,
                    stats: Optional[ShipStats] = None) -> int:
    """The dispatch state machine: look-ahead placement (prefetch), ring
    routing, model enqueue, copy-back start (host_async, prefetch) and
    the bounded drain. Returns the number of chunks dispatched."""
    host_async = strategy in ("host_async", "prefetch")
    prefetch = strategy == "prefetch"
    lookahead = max(1, int(prefetch_depth))
    pending: collections.deque = collections.deque()
    # (valid, placed, stream_through) whose placement already started
    ahead: collections.deque = collections.deque()
    exhausted = False
    batches = 0

    def pull():
        nonlocal exhausted
        nxt = next(chunks, None)
        if nxt is None:
            exhausted = True
        return nxt

    def put(valid, chunk, is_ahead, own=False):
        if is_ahead:
            return start_device_prefetch(xfer, valid, chunk, counters, own)
        return xfer.place(valid, chunk, counters, own=own)

    def place(valid, chunk, is_ahead):
        t0 = time.perf_counter()
        if ring is None:
            placed, through = put(valid, chunk, is_ahead), False
        else:
            placed, through = route(valid, chunk, is_ahead)
        if phases is not None:
            phases.device_put_s += time.perf_counter() - t0
        return placed, through

    def route(valid, chunk, is_ahead):
        """A content hit runs the resident chunk and ships nothing; a
        miss places the chunk and retains it or streams it through."""
        ring.tick()
        fp = ring.fingerprint(chunk, valid, xfer.chunk_size)
        nbytes = sum(int(np.asarray(v)[:valid].nbytes)
                     for v in chunk.values())
        resident = ring.get(fp)
        if resident is not None:
            stats.hits += 1
            stats.resident_bytes += nbytes
            return resident, False
        stats.misses += 1
        stats.shipped_bytes += nbytes
        if ring.note_shipped(fp):
            stats.reshipped_bytes += nbytes
        placed = put(valid, chunk, is_ahead, own=True)
        if ring.admit(fp, placed, nbytes):
            return placed, False
        return placed, True

    while True:
        # keep the look-ahead full: start the host→device copies of up
        # to ``lookahead`` chunks beyond the one about to run
        while prefetch and not exhausted and len(ahead) < lookahead:
            nxt = pull()
            if nxt is None:
                break
            ahead.append((nxt[0],) + place(nxt[0], nxt[1], True))
        if ahead:
            valid, placed, through = ahead.popleft()
        else:
            nxt = pull()
            if nxt is None:
                break
            valid = nxt[0]
            placed, through = place(valid, nxt[1], False)
        maybe_fail("ship.device_put")
        t0 = time.perf_counter()
        if through:
            out, done = dispatch_donated(model_fn, xfer, placed)
            stats.donated += 1
        else:
            out, done = xfer.run(model_fn, placed)
        del placed
        if phases is not None:
            phases.enqueue_s += time.perf_counter() - t0
        if host_async:
            pending.append(start_host_copies(sink, xfer, valid, out, done))
        else:
            pending.append(("out", valid, out, done))
        del out
        batches += 1
        drain_bounded(pending, sink, xfer, max_inflight)
    drain_bounded(pending, sink, xfer, 0)
    return batches


@dataclass
class RunnerMetrics:
    """Throughput and host-copy counters (the JAX runner's field names).

    ``bytes_staged``: input bytes written into staging buffers (every
    chunk on the card; the padded tail on the CPU). ``bytes_copied``:
    input bytes of rows that were not contiguous in the caller's array.
    ``transfer_wait_seconds``: time blocked waiting for results to land
    on the host."""

    rows: int = 0
    batches: int = 0
    seconds: float = 0.0
    bytes_staged: int = 0
    bytes_copied: int = 0
    transfer_wait_seconds: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def add(self, rows: int, batches: int, seconds: float,
            bytes_staged: int = 0, bytes_copied: int = 0,
            transfer_wait_seconds: float = 0.0):
        with self._lock:
            self.rows += rows
            self.batches += batches
            self.seconds += seconds
            self.bytes_staged += bytes_staged
            self.bytes_copied += bytes_copied
            self.transfer_wait_seconds += transfer_wait_seconds

    @property
    def rows_per_second(self) -> float:
        with self._lock:
            return self.rows / self.seconds if self.seconds else 0.0


class BatchRunner:
    """Runs a ModelFunction over host arrays in fixed-size device chunks
    (module docstring for the strategies and the ring)."""

    def __init__(self, model_fn: ModelFunction, batch_size: int = 64,
                 metrics: Optional[RunnerMetrics] = None,
                 strategy: Optional[str] = None,
                 max_inflight: Optional[int] = None,
                 prefetch_depth: Optional[int] = None,
                 infeed_ring: Optional[int] = None):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.model_fn = model_fn
        self.batch_size = batch_size
        self.metrics = metrics or RunnerMetrics()
        self.strategy, self.max_inflight = resolve_strategy(
            strategy, max_inflight)
        self.prefetch_depth = resolve_prefetch_depth(prefetch_depth)
        self.infeed_ring = resolve_infeed_ring(infeed_ring)
        # ring accounting over every run
        self.ship_stats = ShipStats()
        cuda = model_fn.device.type == "cuda"
        # persistent staging, checked out under a try-lock so a
        # concurrent run() uses a private one instead of racing
        self._staging = PinnedStaging() if cuda else PadStaging()
        self._staging_lock = threading.Lock()
        self._streams = ((torch.cuda.Stream(model_fn.device),
                          torch.cuda.Stream(model_fn.device))
                         if cuda else None)
        self._ring: Optional[InfeedRing] = None
        self._ring_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._empty: Optional[Dict[str, np.ndarray]] = None

    @property
    def preferred_chunk(self) -> int:
        """Row count at which run() pads nothing: the device batch.
        Device stages publish it as their plan batch_hint."""
        return self.batch_size

    def _checkout_ring(self):
        """(ring, locked): the persistent ring when engaged and
        uncontended, else (None, False); resizes it when the knob moved
        between runs."""
        depth = int(self.infeed_ring)
        if depth < 2 or not self._ring_lock.acquire(blocking=False):
            return None, False
        if self._ring is None:
            self._ring = InfeedRing(depth)
        else:
            self._ring.resize(depth)
        return self._ring, True

    def ring_state(self) -> Optional[dict]:
        """Live ring telemetry (None when no ring has engaged)."""
        ring = self._ring
        return ring.state() if ring is not None else None

    def warmup(self) -> bool:
        """One zeros run at the device batch (and, with a ring, one per
        slot plus one streaming through), so the first real run pays no
        first-call cost. See :func:`warmup_runner`."""
        return warmup_runner(self)

    def run(self, inputs: Dict[str, np.ndarray],
            phases: Optional[ChunkPhases] = None
            ) -> Dict[str, np.ndarray]:
        """inputs: {name: [N, *row_shape]} → {name: [N, *out_shape]}."""
        n = check_row_counts(inputs)
        if n == 0:
            # before the signature check: an empty column may arrive flat
            return self._empty_outputs()
        check_against_signature(inputs, self.model_fn)
        inputs = {k: np.asarray(inputs[k])
                  for k in self.model_fn.input_names}
        t0 = time.perf_counter()
        counters = CopyCounters()
        # one snapshot of the knobs per run
        batch_size = self.batch_size
        strategy, max_inflight = self.strategy, self.max_inflight
        prefetch_depth = self.prefetch_depth
        out, wait = self._run_device(inputs, n, counters, batch_size,
                                     strategy, max_inflight,
                                     prefetch_depth, phases)
        batches = -(-n // batch_size)
        elapsed = time.perf_counter() - t0
        # the device lane's feed (the engine's host lane is
        # engine.busy_seconds)
        default_registry().counter("device.run_seconds").add(elapsed)
        self.metrics.add(n, batches, elapsed,
                         bytes_staged=counters.bytes_staged,
                         bytes_copied=counters.bytes_copied,
                         transfer_wait_seconds=wait)
        return out

    def _run_device(self, inputs, n, counters: CopyCounters,
                    batch_size: int, strategy: str, max_inflight: int,
                    prefetch_depth: int,
                    phases: Optional[ChunkPhases] = None
                    ) -> Tuple[Dict[str, np.ndarray], float]:
        mf = self.model_fn
        cuda = mf.device.type == "cuda"
        sink = SlabSink(n, mf.output_names,
                        pinned=cuda and strategy in ("host_async",
                                                     "prefetch"))
        staging, locked = checkout_staging(self._staging,
                                           self._staging_lock)
        ring, ring_locked = self._checkout_ring()
        stats = ShipStats() if ring is not None else None
        try:
            xfer = _Transfer(mf.device, batch_size, staging,
                             max_inflight + prefetch_depth + 1,
                             self._streams)
            chunks = iter_padded_chunks(
                inputs, n, batch_size,
                staging if not cuda else None, counters, pad=not cuda)
            dispatch_chunks(mf, chunks, strategy, max_inflight, sink, xfer,
                            counters, prefetch_depth=prefetch_depth,
                            phases=phases, ring=ring, stats=stats)
        finally:
            if ring_locked:
                self._ring_lock.release()
            if locked:
                self._staging_lock.release()
        if stats is not None:
            with self._stats_lock:
                self.ship_stats.add(stats)
        if phases is not None:
            phases.drain_s += sink.transfer_wait
        return sink.result(), sink.transfer_wait

    def _empty_outputs(self) -> Dict[str, np.ndarray]:
        """Zero-row outputs with the per-row shapes and dtypes of the
        model's output signature (made once per runner): a trace under
        ``FakeTensorMode`` that launches nothing, as the JAX runner's
        ``eval_shape``."""
        if self._empty is None:
            self._empty = {
                k: np.zeros((0,) + tuple(shape), dtype)
                for k, (shape, dtype)
                in self.model_fn.output_signature().items()}
        return dict(self._empty)


def warmup_runner(runner) -> bool:
    """Run one zeros batch of ``preferred_chunk`` rows through
    ``runner``; with an infeed ring of K, also K batches of distinct
    content (each fills a slot) and one more that streams through, then
    retire the warm slots so the first real chunks are admitted at
    once."""
    sig = runner.model_fn.input_signature
    n = runner.preferred_chunk
    runner.run({k: np.zeros((n,) + tuple(shape), dtype)
                for k, (shape, dtype) in sig.items()})
    ring_depth = int(getattr(runner, "infeed_ring", 0) or 0)
    if ring_depth >= 2:
        for i in range(1, ring_depth + 1):
            batch = {}
            for k, (shape, dtype) in sig.items():
                arr = np.zeros((n,) + tuple(shape), dtype)
                flat = arr.reshape(-1)
                flat[:min(i, flat.size)] = 1
                batch[k] = arr
            runner.run(batch)
        ring = getattr(runner, "_ring", None)
        if ring is not None:
            ring.retire_all()
    return True
