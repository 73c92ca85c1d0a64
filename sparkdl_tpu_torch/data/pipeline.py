"""Parallel host pipeline — counterpart of ``sparkdl_tpu/data/pipeline.py``:
a plan's host prefix (source load and the host stages before the first
device stage) runs per partition on a pool of workers, with bounded
read-ahead and an ordered re-merge, so host work overlaps the device
stage on the consumer thread instead of taking turns with it.

:class:`~sparkdl_tpu_torch.data.engine.LocalEngine` selects it per
``execute()`` when its ``pipeline_workers`` knob (constructor argument
or :data:`ENV_WORKERS`; a typo degrades to serial) resolves to 2 or
more:

* **process pool** (``pipeline_mode`` ``"process"``, or ``"auto"``):
  each partition's prefix runs in a worker process. Plans and sources
  are shipped with the standard library's ``pickle`` (the JAX package
  uses cloudpickle, which the port does not have), so every source and
  host stage the port builds is a module-level callable. The finished
  fragment comes back in the numpy batch codec (``data/codec.py``):
  fragments of at least :data:`SHM_MIN_BYTES` through a POSIX
  shared-memory segment, which the consumer copies once into a
  ``bytearray`` it owns and unlinks at once; smaller ones ride the
  result pipe. Both count ``pipeline.handoff_bytes``.
* **thread pool**, where the process pool cannot apply: a plan or
  source that ``pickle`` refuses (a lambda or a closure a user handed
  to ``map_batches``), no usable start method, or a pool that broke.
  Counted in ``pipeline.fallbacks`` with one warning, never silent.
* **ordered bounded re-merge**: workers finish in any order; results
  wait in a window of the engine's live ``pipeline_read_ahead`` and
  are yielded in partition order, with row identity and order exact.

Workers start with ``spawn`` where the main module survives re-import,
else ``fork`` — but never ``fork`` once this process has initialised
CUDA (a forked child inherits a CUDA context it cannot use). With no
usable start method the stream takes the counted thread fallback.
Workers never touch the card: only the host prefix leaves the
consumer, and it must hold no model, runner or CUDA tensor.

Degrades, each counted: fewer than 2 workers, a config typo, or a
1-core host in ``"auto"`` mode run the serial path, byte for byte. An
explicit ``"process"`` or ``"thread"`` mode skips the core check.

Failures: a worker raising surfaces one typed error to the consumer
(process-mode exceptions are pickled back and re-raised; one that does
not pickle becomes :class:`PipelineWorkerError`); transient failures
re-run parent-side through the engine's shared
:class:`~sparkdl_tpu_torch.resilience.policy.RetryPolicy`; on error or
early abandonment in-flight siblings are cancelled, effectful plans and
sources drain, and every completed but unconsumed shared-memory segment
is unlinked. Worker busy seconds land in ``engine.busy_seconds`` and
stage seconds in ``engine.stage_seconds.<name>``, as on the serial
path. The JAX package's spans, stall watchdog, cross-process telemetry
frames and ledger worker basis are not ported.
"""

from __future__ import annotations

import logging
import os
import pickle
import sys
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

from sparkdl_tpu_torch.data.codec import (
    Batch,
    decode_batch,
    encode_parts,
    write_parts,
)
from sparkdl_tpu_torch.data.engine import _num_rows, _quiesce
from sparkdl_tpu_torch.obs import default_registry
from sparkdl_tpu_torch.resilience.errors import TransientError

logger = logging.getLogger(__name__)

#: worker-count env knob; 0/unset/typo = serial (the existing path)
ENV_WORKERS = "SPARKDL_TPU_TORCH_PIPELINE_WORKERS"
#: reorder-window env knob; default 2x workers
ENV_READ_AHEAD = "SPARKDL_TPU_TORCH_PIPELINE_READ_AHEAD"
#: pool-mode env knob: auto (process, thread fallback) | process | thread
ENV_MODE = "SPARKDL_TPU_TORCH_PIPELINE_MODE"
#: multiprocessing start-method override
ENV_MPCTX = "SPARKDL_TPU_TORCH_PIPELINE_MPCTX"

_MODES = ("auto", "process", "thread")

#: fragments smaller than this ride the result pipe instead of a
#: shared-memory segment (a segment costs two syscalls and a map)
SHM_MIN_BYTES = 64 * 1024


def _count(what: str, amount: float = 1.0) -> None:
    default_registry().counter(f"pipeline.{what}").add(amount)


def resolve_workers(explicit: Optional[int]) -> int:
    """The requested worker count: an explicit value wins, then
    :data:`ENV_WORKERS`. A typo or negative value degrades to 0
    (serial) with one warning and ``pipeline.config_errors``."""
    if explicit is not None:
        return max(0, int(explicit))
    raw = os.environ.get(ENV_WORKERS, "")
    if not raw:
        return 0
    try:
        val = int(raw)
        if val < 0:
            raise ValueError(val)
        return val
    except ValueError:
        logger.warning("%s=%r is not a non-negative int; running the "
                       "serial host path", ENV_WORKERS, raw)
        _count("config_errors")
        return 0


def resolve_read_ahead(explicit: Optional[int], workers: int) -> int:
    """The reorder-window depth (in-flight partitions ahead of the
    merge point): explicit wins, then :data:`ENV_READ_AHEAD`, then
    twice the workers — with :func:`resolve_workers`' degrade."""
    default = max(2, 2 * max(1, workers))
    if explicit is not None:
        return max(1, int(explicit))
    raw = os.environ.get(ENV_READ_AHEAD, "")
    if not raw:
        return default
    try:
        val = int(raw)
        if val < 1:
            raise ValueError(val)
        return val
    except ValueError:
        logger.warning("%s=%r is not a positive int; using the default "
                       "%d", ENV_READ_AHEAD, raw, default)
        _count("config_errors")
        return default


def resolve_mode(explicit: Optional[str]) -> str:
    """Pool mode: explicit wins, then :data:`ENV_MODE`, then auto."""
    raw = explicit or os.environ.get(ENV_MODE, "") or "auto"
    raw = raw.lower()
    if raw not in _MODES:
        logger.warning("pipeline mode %r is not one of %s; using "
                       "'auto'", raw, _MODES)
        _count("config_errors")
        return "auto"
    return raw


_warned_once: set = set()
_warn_lock = threading.Lock()


def _warn_once(key: str, msg: str, *args) -> None:
    with _warn_lock:
        fire = key not in _warned_once
        _warned_once.add(key)
    if fire:
        logger.warning(msg, *args)


def effective_workers(requested: int, mode: str,
                      record: bool = True) -> int:
    """The worker count a pooled stream runs: 0 (serial) when fewer
    than 2 are requested and, in auto mode only, on a 1-core host.
    An explicit process/thread mode trusts the caller. Degrades count
    ``pipeline.degrade_events`` when ``record``."""
    req = max(0, int(requested))
    if req < 2:
        return 0
    if mode == "auto" and (os.cpu_count() or 1) < 2:
        if record:
            _warn_once("1core",
                       "pipeline: %d workers requested on a 1-core "
                       "host; running the serial host path (explicit "
                       "pipeline_mode forces the pool)", req)
            _count("degrade_events")
        return 0
    return req


def _spawn_safe() -> bool:
    """Whether ``spawn`` works here. Spawned children re-import
    ``__main__`` from its module name or file: a ``python -m`` run or a
    script file qualifies, and so does a main module with neither
    (``python -c``, a REPL, a pytest-xdist worker), which spawn does not
    re-import. A ``python -`` heredoc does not: its ``__file__`` is
    ``<stdin>``, which a child cannot re-run. (The JAX package also
    counts the no-file case as unsafe; its workers may fork, the
    port's must not once CUDA is up.)"""
    main = sys.modules.get("__main__")
    if main is None:
        return False
    if getattr(main, "__spec__", None) is not None:
        return True
    path = getattr(main, "__file__", None)
    return path is None or os.path.exists(str(path))


def _cuda_initialized() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _mp_context():
    """The start method for worker processes: the env override when
    valid, else ``spawn`` where :func:`_spawn_safe` holds, else
    ``fork`` — never ``fork`` once this process has initialised CUDA.
    None = no process pool here (the caller falls back to threads)."""
    import multiprocessing as mp
    avail = mp.get_all_start_methods()
    cuda = _cuda_initialized()
    raw = os.environ.get(ENV_MPCTX, "")
    if raw:
        if raw in avail and not (raw == "fork" and cuda):
            return mp.get_context(raw)
        if raw == "fork" and cuda:
            logger.warning("%s=fork refused: this process has "
                           "initialised CUDA, which a forked worker "
                           "cannot use; auto-selecting", ENV_MPCTX)
        else:
            logger.warning("%s=%r is not one of %s; auto-selecting",
                           ENV_MPCTX, raw, avail)
        _count("config_errors")
    if "spawn" in avail and _spawn_safe():
        return mp.get_context("spawn")
    if "fork" in avail and not cuda:
        return mp.get_context("fork")
    return None


class PipelineWorkerError(RuntimeError):
    """A pooled worker failed in a way that could not be reported as
    its original typed exception (the exception did not pickle, or the
    process died). Carries the worker-side repr."""


class PipelineHandoffError(TransientError):
    """The shared-memory hand-off of a finished fragment failed on the
    consumer side (segment missing). Typed transient, so the
    parent-side retry fires: a re-run makes the segment anew."""


# ---------------------------------------------------------------------------
# worker side (runs in the pool process or on a DecodeServer)
# ---------------------------------------------------------------------------

#: per-worker-process plan cache, keyed by stream token: every task
#: carries its stream's pickled plan (any task can land on any worker),
#: each worker loads it once. A few entries, oldest out, so concurrent
#: streams sharing a pool do not thrash one slot.
_PLAN_CACHE: "OrderedDict[str, list]" = OrderedDict()
_PLAN_CACHE_MAX = 4
_plan_cache_lock = threading.Lock()


def _load_plan(token: str, plan_blob: bytes) -> list:
    with _plan_cache_lock:
        plan = _PLAN_CACHE.get(token)
        if plan is not None:
            _PLAN_CACHE.move_to_end(token)
            return plan
    plan = pickle.loads(plan_blob)
    with _plan_cache_lock:
        _PLAN_CACHE[token] = plan
        while len(_PLAN_CACHE) > _PLAN_CACHE_MAX:
            _PLAN_CACHE.popitem(last=False)
    return plan


def _to_segment(parts, total: int) -> Optional[str]:
    """Write an encoded fragment into a new shared-memory segment whose
    ownership moves to the consumer; None when no segment can be made
    (no ``/dev/shm``, or a full one): the fragment then rides the
    pipe."""
    from multiprocessing import resource_tracker, shared_memory
    try:
        # a segment larger than the room left in /dev/shm is created
        # sparse and faults (SIGBUS) on the write: check first
        st = os.statvfs("/dev/shm")
        if st.f_bavail * st.f_frsize < total:
            logger.warning("pipeline: %d bytes do not fit in /dev/shm; "
                           "fragment rides the result pipe", total)
            return None
    except OSError:
        pass        # no /dev/shm to ask: shared_memory decides below
    try:
        shm = shared_memory.SharedMemory(create=True, size=total)
    except OSError as e:
        logger.warning("pipeline: shared-memory segment unavailable "
                       "(%s); fragment rides the result pipe", e)
        return None
    try:
        write_parts(parts, shm.buf)
        name = shm.name
        # the consumer unlinks it; without this the worker's resource
        # tracker would unlink it when the pool retires the process
        resource_tracker.unregister(shm._name, "shared_memory")
    finally:
        shm.close()
    return name


def _pooled_partition_task(token: str, plan_blob: bytes, src_blob: bytes,
                           index: int, shm_min: int) -> tuple:
    """One partition's source load and host-stage prefix, in a worker.
    Returns a plain-picklable tuple and never raises:

    ``("shm", name, nbytes, busy_s, timings, rows)`` — the fragment in
    a shared-memory segment the consumer owns from here on;
    ``("buf", payload, busy_s, timings, rows)`` — a small fragment in
    the tuple itself (a ``bytearray``, so the consumer's arrays are
    writable);
    ``("err", exc_blob_or_None, repr, type_name)`` — the failure,
    pickled where it pickles."""
    try:
        plan = _load_plan(token, plan_blob)
        source = pickle.loads(src_blob)
        logical = getattr(source, "logical_index", None)
        if logical is not None:
            index = logical
        # the engine's fault sites apply to pooled partitions too (an
        # env-armed SPARKDL_TPU_FAULTS reaches spawned workers)
        from sparkdl_tpu_torch.resilience.faults import maybe_fail
        try:
            maybe_fail("pipeline.worker_death")
        except Exception:
            # the worker-death drill: a real corpse (the parent sees
            # BrokenProcessPool, as after an OOM kill)
            os._exit(1)
        maybe_fail("pipeline.worker_decode")
        maybe_fail("engine.source_load")
        busy = 0.0
        timings: List[Tuple[str, float, int]] = []
        t0 = time.perf_counter()
        batch = source.load()
        busy += time.perf_counter() - t0
        for stage in plan:
            maybe_fail("engine.stage_apply")
            rows_in = _num_rows(batch)
            t0 = time.perf_counter()
            batch = (stage.fn(batch, index) if stage.with_index
                     else stage.fn(batch))
            dt = time.perf_counter() - t0
            busy += dt
            timings.append((stage.name, dt, rows_in))
        rows = _num_rows(batch)
        parts, total = encode_parts(batch)
        if total >= shm_min:
            name = _to_segment(parts, total)
            if name is not None:
                return ("shm", name, total, busy, timings, rows)
        payload = bytearray(total)
        write_parts(parts, memoryview(payload))
        return ("buf", payload, busy, timings, rows)
    except Exception as exc:  # ships back typed; never raises
        exc.__traceback__ = None
        try:
            blob = pickle.dumps(exc)
        except Exception:
            blob = None
        return ("err", blob, repr(exc), type(exc).__name__)


# ---------------------------------------------------------------------------
# consumer side
# ---------------------------------------------------------------------------

def _release_result(result: tuple) -> None:
    """Free a completed but unconsumed task result (early stop or error
    abandonment): its shared-memory segment must be unlinked or the
    abandoned stream leaks ``/dev/shm``."""
    if not isinstance(result, tuple) or not result or result[0] != "shm":
        return
    from multiprocessing import shared_memory
    try:
        shm = shared_memory.SharedMemory(name=result[1])
        shm.close()
        shm.unlink()
        _count("fragments_discarded")
    except FileNotFoundError:
        logger.debug("pipeline: abandoned fragment %r already "
                     "released", result[1])
    except OSError as e:
        _count("handoff_errors")
        logger.warning("pipeline: releasing an abandoned fragment "
                       "failed: %s", e)


def _raise_worker_error(result: tuple) -> None:
    _kind, blob, rep, type_name = result
    if blob is not None:
        try:
            exc = pickle.loads(blob)
        except Exception:
            exc = None
        if isinstance(exc, BaseException):
            raise exc
    raise PipelineWorkerError(
        f"pooled worker failed with {type_name}: {rep}")


def _consume_result(result: tuple) -> Tuple[Batch, float, List[tuple]]:
    """A task result tuple → (batch, busy seconds, stage timings). A
    shared-memory fragment is copied once into a ``bytearray`` this
    process owns and the segment is unlinked at once; the batch's
    arrays are views over those bytes."""
    kind = result[0]
    if kind == "err":
        _raise_worker_error(result)
    t0 = time.perf_counter()
    if kind == "shm":
        _, name, nbytes, busy, timings, _rows = result
        from multiprocessing import shared_memory
        try:
            shm = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            _count("handoff_errors")
            raise PipelineHandoffError(
                f"shared-memory segment {name!r} vanished before the "
                "fragment was consumed") from None
        try:
            data = bytearray(shm.buf[:nbytes])  # the one bounded copy
        finally:
            shm.close()
            try:
                shm.unlink()
            except FileNotFoundError:
                logger.debug("pipeline: segment %r already unlinked",
                             name)
        _count("shm_segments")
    else:
        _, data, busy, timings, _rows = result
    batch = decode_batch(data)
    _count("handoff_seconds", time.perf_counter() - t0)
    _count("handoff_bytes", len(data))
    return batch, busy, list(timings)


def record_worker_time(busy: float, timings) -> None:
    """Fold a worker's host busy seconds and stage timings into this
    process's registry: the worker's own registry dies with it."""
    reg = default_registry()
    reg.counter("engine.busy_seconds").add(busy)
    for name, seconds, _rows in timings:
        reg.counter(f"engine.stage_seconds.{name}").add(seconds)


_active_streams: Dict[int, int] = {}   # stream id -> workers
_active_lock = threading.Lock()
_stream_seq = 0


def _enter_stream(workers: int) -> int:
    global _stream_seq
    with _active_lock:
        _stream_seq += 1
        sid = _stream_seq
        _active_streams[sid] = workers
        live = max(_active_streams.values())
    default_registry().gauge("pipeline.workers").set(live)
    return sid


def _exit_stream(sid: int) -> None:
    with _active_lock:
        _active_streams.pop(sid, None)
        live = max(_active_streams.values(), default=0)
    default_registry().gauge("pipeline.workers").set(live)


# the last-resolved configuration, for state()
_last_state: Dict[str, Any] = {}
_state_lock = threading.Lock()


def _record_state(**kv) -> None:
    with _state_lock:
        _last_state.update(kv)


def state() -> Dict[str, Any]:
    """The pipeline's state as a plain dict: the last stream's resolved
    mode, workers and read-ahead, the live stream count, and the
    ``pipeline.*`` counters."""
    snap = default_registry().snapshot()
    with _state_lock:
        out = dict(_last_state)
    with _active_lock:
        out["streams_active"] = len(_active_streams)
    out["counters"] = {k: v for k, v in snap.items()
                       if k.startswith("pipeline.")}
    return out


class _PoolHandle:
    """One pool generation. Streams pin the handle for their whole life
    (``refs``), so a live resize builds a new generation for new
    streams instead of shutting down the one a concurrent stream is
    still draining; a retired generation shuts down when its last
    holder releases it."""

    __slots__ = ("pool", "workers", "refs", "retired")

    def __init__(self, pool, workers: int):
        self.pool = pool
        self.workers = workers
        self.refs = 0
        self.retired = False


class HostPipeline:
    """The engine-owned worker pools and ordered re-merge (module
    docstring). One per :class:`LocalEngine`, built lazily on the first
    pooled ``execute()``; pools persist across executes and are rebuilt
    at a new size when ``pipeline_workers`` moves (in-flight streams
    keep their pinned :class:`_PoolHandle`)."""

    def __init__(self, mode: Optional[str] = None,
                 shm_min_bytes: int = SHM_MIN_BYTES):
        self.mode = resolve_mode(mode)
        self.shm_min_bytes = int(shm_min_bytes)
        self._lock = threading.Lock()
        self._proc_handle: Optional[_PoolHandle] = None
        self._proc_broken = False
        self._thread_handle: Optional[_PoolHandle] = None

    # locks and pools never ship: a pickled pipeline arrives config-only
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        state["_proc_handle"] = None
        state["_proc_broken"] = False
        state["_thread_handle"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    # -- pools ---------------------------------------------------------------

    def _retire_locked(self, handle: Optional[_PoolHandle]
                       ) -> Optional[_PoolHandle]:
        """Mark ``handle`` retired (the caller holds the lock); returns
        it when no stream pins it, i.e. when the caller must shut it
        down (outside the lock)."""
        if handle is None:
            return None
        handle.retired = True
        return handle if handle.refs <= 0 else None

    def _acquire_process(self, workers: int) -> Optional[_PoolHandle]:
        """Pin the process-pool generation of ``workers`` for one
        stream (rebuilding when the knob moved); None when no start
        method is usable or a previous pool broke."""
        from concurrent.futures import ProcessPoolExecutor
        with self._lock:
            if self._proc_broken:
                return None
            h = self._proc_handle
            if h is not None and h.workers == workers:
                h.refs += 1
                return h
        ctx = _mp_context()
        if ctx is None:
            return None
        new = _PoolHandle(
            ProcessPoolExecutor(max_workers=workers, mp_context=ctx),
            workers)
        new.refs = 1
        shut = None
        with self._lock:
            h = self._proc_handle
            if self._proc_broken:
                shut, new = new, None      # broke while building
            elif h is not None and h.workers == workers:
                h.refs += 1                # lost a racing same-size build
                shut, new = new, h
            else:
                self._proc_handle = new
                shut = self._retire_locked(h)
        if shut is not None:
            shut.pool.shutdown(wait=False, cancel_futures=True)
        return new

    def _acquire_thread(self, workers: int) -> _PoolHandle:
        """The thread-pool analogue of :meth:`_acquire_process`."""
        with self._lock:
            h = self._thread_handle
            if h is not None and h.workers == workers:
                h.refs += 1
                return h
            new = _PoolHandle(
                ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="sparkdl-torch-pipeline"),
                workers)
            new.refs = 1
            self._thread_handle = new
            shut = self._retire_locked(h)
        if shut is not None:
            shut.pool.shutdown(wait=False, cancel_futures=True)
        return new

    def _release(self, handle: Optional[_PoolHandle]) -> None:
        """A stream is done with its pinned generation; a retired one
        shuts down when its last holder leaves."""
        if handle is None:
            return
        with self._lock:
            handle.refs -= 1
            shut = handle.retired and handle.refs <= 0
        if shut:
            handle.pool.shutdown(wait=False, cancel_futures=True)

    def _mark_broken(self) -> None:
        with self._lock:
            self._proc_broken = True
            shut = self._retire_locked(self._proc_handle)
            self._proc_handle = None
        if shut is not None:
            shut.pool.shutdown(wait=False, cancel_futures=True)

    def shutdown(self) -> None:
        with self._lock:
            handles = (self._proc_handle, self._thread_handle)
            self._proc_handle = None
            self._thread_handle = None
            for h in handles:
                if h is not None:
                    h.retired = True
        for h in handles:
            if h is not None:
                h.pool.shutdown(wait=False, cancel_futures=True)

    # -- the pooled stream ---------------------------------------------------

    def stream(self, sources: Sequence, plan: Sequence, engine,
               workers: int) -> Iterator[Tuple[int, Batch]]:
        """Yield ``(logical_index, fragment)`` in partition order with
        ``workers`` pool workers and the engine's live read-ahead
        window."""
        plan = list(plan)
        mode = self.mode
        payload = None
        handle = None
        if mode in ("auto", "process"):
            payload = pickle_payload(sources, plan, "pipeline",
                                     "process pool falls back to threads")
            if payload is not None:
                handle = self._acquire_process(workers)
            if handle is None:
                if payload is not None:
                    _warn_once("noproc",
                               "pipeline: no usable process pool here "
                               "(no start method, CUDA already up with "
                               "no spawn, or a broken pool); falling "
                               "back to the thread pool")
                    _count("fallbacks")
                mode = "thread"
            else:
                mode = "process"
        read_ahead = max(1, int(getattr(engine, "pipeline_read_ahead",
                                        0) or 1))
        _record_state(mode=mode, workers=workers, read_ahead=read_ahead,
                      shm_min_bytes=self.shm_min_bytes)
        default_registry().gauge("pipeline.read_ahead").set(read_ahead)
        if mode == "process":
            return self._stream_process(sources, plan, engine, workers,
                                        payload, handle)
        return self._stream_thread(sources, plan, engine, workers)

    def _stream_thread(self, sources, plan, engine, workers):
        """Thread mode: tasks run the engine's own retrying
        ``_run_partition``."""
        handle = self._acquire_thread(workers)

        def submit(pos: int) -> Future:
            return handle.pool.submit(engine._run_partition,
                                      sources[pos], plan, pos)

        return self._merge(sources, plan, engine, submit, consume=None,
                           resubmit=None, handle=handle)

    def _stream_process(self, sources, plan, engine, workers, payload,
                        handle: _PoolHandle):
        plan_blob, src_blobs = payload
        token = uuid.uuid4().hex

        def submit(pos: int) -> Future:
            from concurrent.futures.process import BrokenProcessPool
            try:
                return handle.pool.submit(_pooled_partition_task, token,
                                          plan_blob, src_blobs[pos], pos,
                                          self.shm_min_bytes)
            except BrokenProcessPool as exc:
                self._broken(exc)

        def consume(pos: int, result: tuple) -> Batch:
            batch, busy, timings = _consume_result(result)
            record_worker_time(busy, timings)
            return batch

        return self._merge(sources, plan, engine, submit, consume=consume,
                           resubmit=submit, handle=handle)

    def _broken(self, exc: BaseException) -> None:
        """A worker died (OOM, kill) and took the pool with it: this
        stream fails typed; later streams fall back to threads."""
        self._mark_broken()
        _count("fallbacks")
        raise PipelineWorkerError(
            "process pool broke mid-stream (a worker process died); "
            "subsequent pooled streams fall back to the thread pool"
        ) from exc

    def _merge(self, sources, plan, engine, submit, consume, resubmit,
               handle: Optional[_PoolHandle]):
        """The ordered bounded re-merge, one generator for both modes.
        ``consume`` turns a raw future result into a batch (process
        mode); ``resubmit`` enables the parent-side retry through the
        engine's shared RetryPolicy (process mode only: thread-mode
        tasks retry inside ``_run_partition``)."""
        from concurrent.futures.process import BrokenProcessPool
        drain = (any(getattr(st, "effectful", False) for st in plan)
                 or any(getattr(src, "effectful", False)
                        for src in sources))
        reg = default_registry()
        inflight = reg.gauge("pipeline.inflight")
        inflight_peak = reg.gauge("pipeline.inflight_peak")

        def _logical(pos: int) -> int:
            logical = getattr(sources[pos], "logical_index", None)
            return pos if logical is None else logical

        def _raw(fut: Future):
            try:
                return fut.result()
            except BrokenProcessPool as exc:
                self._broken(exc)

        def _result(pos: int, fut: Future):
            raw = _raw(fut)
            if consume is None:
                return raw
            try:
                return consume(pos, raw)
            except Exception as exc:
                if resubmit is None:
                    raise
                # parent-side re-runs through the shared RetryPolicy,
                # grant by grant (attempt 1, the pooled task, happened)
                policy = engine.retry_policy
                on_retry = engine._log_retry(
                    f"pooled partition {_logical(pos)}")
                key = f"pipeline:{_logical(pos)}"
                policy.deposit()
                attempt = 1
                while True:
                    delay = policy.grant(attempt, exc, key=key)
                    if delay is None:
                        raise exc
                    on_retry(attempt, exc, delay)
                    time.sleep(delay)
                    try:
                        return consume(pos, _raw(resubmit(pos)))
                    except Exception as retry_exc:
                        attempt += 1
                        exc = retry_exc

        def _gen():
            sid = _enter_stream(handle.workers if handle else 0)
            pending: Dict[int, Future] = {}
            next_to_submit = 0
            next_to_yield = 0
            n = len(sources)
            try:
                while next_to_yield < n:
                    window = max(1, int(getattr(
                        engine, "pipeline_read_ahead", 0) or 1))
                    while next_to_submit < n and len(pending) < window:
                        pending[next_to_submit] = submit(next_to_submit)
                        next_to_submit += 1
                        inflight.set(len(pending))
                        inflight_peak.set_max(len(pending))
                    pos = next_to_yield
                    fut = pending.pop(pos)
                    try:
                        batch = _result(pos, fut)
                    finally:
                        inflight.set(len(pending))
                    _count("tasks")
                    _count("rows", _num_rows(batch))
                    yield _logical(pos), batch
                    next_to_yield += 1
            finally:
                for fut in pending.values():
                    # a running or finished task cannot be cancelled:
                    # release its shared-memory segment when it lands
                    if not fut.cancel() and consume is not None:
                        fut.add_done_callback(_on_abandoned)
                if drain:
                    # quiesce: an effectful straggler finishing after
                    # the caller's cleanup ran corrupts its outcome
                    _quiesce(pending.values())
                inflight.set(0)
                _exit_stream(sid)
                self._release(handle)

        return _gen()

    def describe(self) -> Dict[str, Any]:
        with self._lock:
            ph, th = self._proc_handle, self._thread_handle
            return {"mode": self.mode,
                    "process_pool_workers":
                        ph.workers if ph is not None else 0,
                    "process_pool_broken": self._proc_broken,
                    "thread_pool_workers":
                        th.workers if th is not None else 0,
                    "shm_min_bytes": self.shm_min_bytes}


def _on_abandoned(fut: Future) -> None:
    try:
        result = fut.result()
    except Exception as e:
        logger.debug("pipeline: abandoned task failed: %s", e)
        return
    _release_result(result)


def pickle_payload(sources: Sequence, plan: Sequence, what: str,
                   consequence: str
                   ) -> Optional[Tuple[bytes, List[bytes]]]:
    """(plan blob, per-source blobs) pickled with the standard library,
    or None, with one warning and ``<what>.fallbacks`` counted, when
    something in them does not pickle (a lambda or closure)."""
    try:
        plan_blob = pickle.dumps(list(plan), pickle.HIGHEST_PROTOCOL)
        src_blobs = [pickle.dumps(s, pickle.HIGHEST_PROTOCOL)
                     for s in sources]
        return plan_blob, src_blobs
    except (pickle.PicklingError, TypeError, AttributeError) as e:
        _warn_once(f"{what}:pickle:{type(e).__name__}",
                   "%s: plan/source does not pickle (%s: %s); %s",
                   what, type(e).__name__, e, consequence)
        default_registry().counter(f"{what}.fallbacks").add()
        return None

