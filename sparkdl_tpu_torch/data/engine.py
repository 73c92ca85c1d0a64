"""Local partition-parallel execution engine — counterpart of
``sparkdl_tpu/data/engine.py::LocalEngine``.

Host stages (decode, pack, numpy shuffling) and source loads run
concurrently on a thread pool, while device stages (model applies
through the batch runner) run one at a time behind a lock, so the card
sees one batch stream and its memory is not oversubscribed by
concurrent partitions. Results stream back in partition order, with at
most ``max_inflight`` partitions in flight.

Plans holding a re-chunkable device stage (row-preserving, index-free,
with a ``Stage.batch_hint``) run in two phases: the host prefix runs
per partition on the pool as always, then the ordered partition stream
flows through the remaining stages on the consumer thread — the device
stage is fed row blocks cut at multiples of its hint that span
partition boundaries, and its outputs are re-sliced to the original
partitions, so partitions smaller than the device batch stop padding
it.

Fragments are numpy batches (dict of column → ndarray): a block that is
one fragment, or a leading slice of one, is a view; only a block that
spans fragments is concatenated.

Transient failures are retried per partition (or per stream-stage
call) through one shared :class:`~sparkdl_tpu_torch.resilience.policy.
RetryPolicy`; each granted retry counts in :attr:`LocalEngine.retries`
and in the registry's ``engine.retries``. Host work (source loads and
host stages) counts its seconds in ``engine.busy_seconds``, and each
stage in ``engine.stage_seconds.<name>`` (``sparkdl_tpu_torch/obs``).

With ``pipeline_workers >= 2`` (constructor or
``SPARKDL_TPU_TORCH_PIPELINE_WORKERS``; typos degrade to serial) the
host prefix, everything before the first device stage, runs on the
parallel host pipeline (``data/pipeline.py``): a process pool (threads
where the plan does not pickle) loads and decodes each partition, hands
the fragment back through shared memory in the numpy batch codec, and an
ordered bounded re-merge feeds the same consumer-thread re-chunk and
device path. With ``inputsvc_endpoints`` (or
``SPARKDL_TPU_TORCH_INPUTSVC_WORKERS``) the prefix runs on a remote
decode fleet instead (``inputsvc/``), falling back loudly to the local
paths when no endpoint answers. The device stage never leaves the
consumer.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.data.tensors import Batch
from sparkdl_tpu_torch.obs import default_registry
from sparkdl_tpu_torch.resilience.errors import (
    default_retryable_exceptions,
    is_deterministic_device_error,
)
from sparkdl_tpu_torch.resilience.faults import maybe_fail
from sparkdl_tpu_torch.resilience.policy import RetryPolicy

logger = logging.getLogger(__name__)

#: the engine's retry pacing: short backoff (partition re-runs are
#: batch work racing nothing), generous budget (ratio 1.0 bounds
#: sustained amplification at 2x offered load)
ENGINE_RETRY_BASE_BACKOFF_S = 0.02
ENGINE_RETRY_MAX_BACKOFF_S = 1.0
ENGINE_RETRY_BUDGET_RATIO = 1.0
ENGINE_RETRY_BUDGET_CAP = 16.0


def _num_rows(batch: Batch) -> int:
    return len(next(iter(batch.values()))) if batch else 0


def _slice(batch: Batch, lo: int, hi: Optional[int] = None) -> Batch:
    return {k: v[lo:hi] for k, v in batch.items()}


def _concat_batches(frags: Sequence[Batch]) -> Batch:
    if len(frags) == 1:
        return frags[0]
    return {k: np.concatenate([f[k] for f in frags]) for k in frags[0]}


def _take_rows(frags: list, n: int) -> Batch:
    """Remove and return the first ``n`` rows from a fragment list
    (views; a copy only when a block spans fragments)."""
    take = []
    taken = 0
    while taken < n:
        b = frags[0]
        rows = _num_rows(b)
        need = n - taken
        if rows <= need:
            take.append(b)
            taken += rows
            frags.pop(0)
        else:
            take.append(_slice(b, 0, need))
            frags[0] = _slice(b, need)
            taken = n
    return _concat_batches(take)


class LocalEngine:
    """Thread-pool engine with ordered streaming and bounded in-flight
    partitions.

    ``num_workers``: host threads (default ``min(32, cpu_count)``).
    ``max_inflight``: partitions in flight at once (default twice the
    workers; re-chunked plans widen it adaptively unless it was given).
    ``max_retries``: re-attempts of a transiently failing partition.
    ``retryable_exceptions``: the retryable set (default
    :func:`~sparkdl_tpu_torch.resilience.errors.
    default_retryable_exceptions`); CUDA errors are never retried.
    ``pipeline_workers``, ``pipeline_read_ahead``, ``pipeline_mode``:
    the parallel host pipeline's knobs (``data/pipeline.py``; None
    reads the ``SPARKDL_TPU_TORCH_PIPELINE_*`` env vars), plain
    attributes re-read at every ``execute()``. ``inputsvc_endpoints``:
    the decode fleet, ``"host:port,..."`` or a list (None reads
    ``SPARKDL_TPU_TORCH_INPUTSVC_WORKERS``); ``inputsvc_workers`` is
    the live fan-out width."""

    def __init__(self, num_workers: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 max_retries: int = 2,
                 retryable_exceptions: Optional[Tuple[type, ...]] = None,
                 pipeline_workers: Optional[int] = None,
                 pipeline_read_ahead: Optional[int] = None,
                 pipeline_mode: Optional[str] = None,
                 inputsvc_endpoints=None):
        from sparkdl_tpu_torch.data.pipeline import (
            resolve_mode,
            resolve_read_ahead,
            resolve_workers,
        )
        from sparkdl_tpu_torch.inputsvc.client import resolve_endpoints
        self.num_workers = num_workers or min(32, (os.cpu_count() or 4))
        self.pipeline_workers = resolve_workers(pipeline_workers)
        self.pipeline_read_ahead = resolve_read_ahead(
            pipeline_read_ahead, self.pipeline_workers)
        self.pipeline_mode = resolve_mode(pipeline_mode)
        self.inputsvc_endpoints = resolve_endpoints(inputsvc_endpoints)
        self.inputsvc_workers = len(self.inputsvc_endpoints)
        # a falsy max_inflight is not an explicit window: it would
        # disable the adaptive widening for a value the caller never got
        self._explicit_inflight = (max_inflight is not None
                                   and max_inflight > 0)
        self.max_inflight = (max_inflight if self._explicit_inflight
                             else self.num_workers * 2)
        self.max_retries = max_retries
        # an explicit () means "retry nothing"
        self.retryable_exceptions = (
            tuple(retryable_exceptions) if retryable_exceptions is not None
            else default_retryable_exceptions())
        self.retries = 0
        self._local_state()

    def _local_state(self) -> None:
        """What never ships: the thread pool, the locks and the retry
        policy's budget, made anew in each process."""
        # one policy shared by every pool worker and the consumer
        # thread: the budget only bounds amplification if shared
        self.retry_policy = RetryPolicy(
            attempts=1 + max(0, self.max_retries),
            base_backoff_s=ENGINE_RETRY_BASE_BACKOFF_S,
            max_backoff_s=ENGINE_RETRY_MAX_BACKOFF_S,
            budget_ratio=ENGINE_RETRY_BUDGET_RATIO,
            budget_cap=ENGINE_RETRY_BUDGET_CAP,
            retryable=self._retryable)
        self._pool = ThreadPoolExecutor(
            max_workers=self.num_workers,
            thread_name_prefix="sparkdl-tpu-torch-host")
        self._device_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._pipeline = None           # the HostPipeline, built lazily
        self._pipeline_lock = threading.Lock()

    # pools, locks and sockets do not pickle: a shipped engine carries
    # its configuration and builds its pools on first use
    def __getstate__(self):
        state = self.__dict__.copy()
        for name in ("retry_policy", "_pool", "_device_lock",
                     "_count_lock", "_pipeline", "_pipeline_lock"):
            del state[name]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._local_state()

    def _retryable(self, exc: BaseException) -> bool:
        """Inside the configured exception set and not a CUDA error (a
        re-run in this process cannot fix one)."""
        return (isinstance(exc, self.retryable_exceptions)
                and not is_deterministic_device_error(exc))

    def _run_stage(self, stage, batch: Batch, index: int) -> Batch:
        maybe_fail("engine.stage_apply")
        t0 = time.perf_counter()
        out = (stage.fn(batch, index) if stage.with_index
               else stage.fn(batch))
        dt = time.perf_counter() - t0
        reg = default_registry()
        if stage.kind != "device":
            # device stages wrap runner.run, which feeds
            # device.run_seconds itself
            reg.counter("engine.busy_seconds").add(dt)
        reg.counter(f"engine.stage_seconds.{stage.name}").add(dt)
        return out

    def _run_once(self, source, plan, index: int) -> Batch:
        maybe_fail("engine.source_load")
        t0 = time.perf_counter()
        batch = source.load()
        default_registry().counter("engine.busy_seconds").add(
            time.perf_counter() - t0)
        for stage in plan:
            if stage.kind == "device":
                with self._device_lock:
                    batch = self._run_stage(stage, batch, index)
            else:
                batch = self._run_stage(stage, batch, index)
        return batch

    def _run_partition(self, source, plan, index: int) -> Batch:
        # with_index stages see the partition's logical identity
        logical = getattr(source, "logical_index", None)
        if logical is not None:
            index = logical
        # a transient failure re-runs the partition from its source
        return self.retry_policy.call(
            lambda: self._run_once(source, plan, index),
            key=f"partition:{index}",
            on_retry=self._log_retry(f"partition {index}"))

    def _log_retry(self, what: str):
        def on_retry(attempt, exc, delay_s):
            with self._count_lock:
                self.retries += 1
            default_registry().counter("engine.retries").add()
            logger.warning(
                "%s attempt %d/%d failed (%s); retrying in %.3fs",
                what, attempt, 1 + max(0, self.max_retries), exc,
                delay_s)
        return on_retry

    @staticmethod
    def _rechunkable(stage) -> bool:
        """Whether the engine may feed this stage row blocks cut at its
        ``batch_hint``: device stages that preserve rows 1:1 and don't
        depend on partition identity."""
        return (stage.kind == "device" and stage.row_preserving
                and not stage.with_index
                and bool(getattr(stage, "batch_hint", None)))

    def execute(self, sources: Sequence, plan: Sequence) -> Iterator[Batch]:
        """Yield transformed partition batches in partition order, running
        at most ``max_inflight`` partitions concurrently.

        Plans whose tail holds a re-chunkable device stage split in two:
        the host prefix runs per partition on the pool, then the ordered
        partition stream flows through the remaining stages on the
        consumer thread (module docstring)."""
        if not sources:
            return iter(())
        plan = list(plan)
        if self.inputsvc_endpoints and int(self.inputsvc_workers
                                           or 0) >= 1:
            # the decode fleet; None when nothing pickles or no
            # endpoint answers (counted, warned): the local paths below
            remoted = self._execute_remote(sources, plan)
            if remoted is not None:
                return remoted
        if int(self.pipeline_workers or 0) >= 2:
            # the parallel host pipeline; None when it resolves to
            # serial (1-core auto mode): the path below, unchanged
            pipelined = self._execute_pipelined(sources, plan)
            if pipelined is not None:
                return pipelined
        split = next((i for i, st in enumerate(plan)
                      if self._rechunkable(st)), None)
        if split is None:
            return (b for _, b in self._execute_indexed(sources, plan))
        # While the consumer blocks in a device call, the pool keeps
        # loading partitions ahead: the window must cover a device
        # chunk's worth of small partitions, so the first re-chunk stage
        # widens it from real partition sizes (up to 16) unless the
        # caller gave max_inflight.
        inflight_box = [self.max_inflight]
        hints = [int(st.batch_hint) for st in plan[split:]
                 if self._rechunkable(st)]
        stream = self._execute_indexed(sources, plan[:split],
                                       inflight_box=inflight_box)
        first = True
        for stage in plan[split:]:
            if self._rechunkable(stage):
                widen = first and not self._explicit_inflight
                stream = self._stream_rechunk(
                    stream, stage,
                    inflight_box=inflight_box if widen else None,
                    max_hint=max(hints))
                first = False
            elif stage.kind == "device":
                stream = self._stream_plain(stream, stage)
            else:
                # host stages after the device stage keep pool
                # parallelism, so device dispatch never waits on them
                stream = self._stream_pooled(stream, stage)
        return (b for _, b in stream)

    def _host_pipeline(self):
        from sparkdl_tpu_torch.data.pipeline import HostPipeline
        with self._pipeline_lock:
            if self._pipeline is None:
                self._pipeline = HostPipeline(mode=self.pipeline_mode)
            return self._pipeline

    def _stream_tail(self, stream, plan: Sequence):
        """The stages after the host prefix on the consumer thread:
        re-chunkable device stages get hint-aligned blocks, other device
        stages run as they come, later host stages keep the pool."""
        hints = [int(st.batch_hint) for st in plan
                 if self._rechunkable(st)]
        for stage in plan:
            if self._rechunkable(stage):
                # no adaptive widening: the read-ahead window is the
                # pooled look-ahead
                stream = self._stream_rechunk(stream, stage,
                                              max_hint=max(hints))
            elif stage.kind == "device":
                stream = self._stream_plain(stream, stage)
            else:
                stream = self._stream_pooled(stream, stage)
        return (b for _, b in stream)

    @staticmethod
    def _device_split(plan: Sequence) -> int:
        return next((i for i, st in enumerate(plan)
                     if st.kind == "device"), len(plan))

    def _execute_remote(self, sources: Sequence, plan: Sequence
                        ) -> Optional[Iterator[Batch]]:
        """The decode-fleet mode (``inputsvc/``): the host prefix runs
        on remote DecodeServers, ``inputsvc_workers`` of them at most,
        with an ordered re-merge; None when no remote stream can run
        (the caller takes the local paths)."""
        from sparkdl_tpu_torch.inputsvc.client import RemotePipeline
        width = max(1, int(self.inputsvc_workers))
        dsplit = self._device_split(plan)
        stream = RemotePipeline(self.inputsvc_endpoints[:width]).stream(
            sources, plan[:dsplit], self)
        if stream is None:
            return None
        return self._stream_tail(stream, plan[dsplit:])

    def _execute_pipelined(self, sources: Sequence, plan: Sequence
                           ) -> Optional[Iterator[Batch]]:
        """The pooled mode (``data/pipeline.py``): the host prefix runs
        per partition on the worker pool; None when the pool resolves
        to serial."""
        from sparkdl_tpu_torch.data import pipeline as host_pipeline
        workers = host_pipeline.effective_workers(
            int(self.pipeline_workers), self.pipeline_mode)
        if workers < 2:
            return None
        dsplit = self._device_split(plan)
        stream = self._host_pipeline().stream(sources, plan[:dsplit],
                                              self, workers)
        return self._stream_tail(stream, plan[dsplit:])

    def _execute_indexed(self, sources: Sequence, plan: Sequence,
                         inflight_box: Optional[list] = None
                         ) -> Iterator[Tuple[int, Batch]]:
        """The pooled per-partition path, yielding ``(logical_index,
        batch)`` in partition order. ``inflight_box`` is a one-element
        window size a downstream re-chunk stage may widen."""
        box = inflight_box or [self.max_inflight]
        # drain in-flight siblings on exit only when the plan or a
        # source has side effects; pure plans cancel, so take-first
        # callers do not wait for a wave of decodes
        drain = (any(getattr(st, "effectful", False) for st in plan)
                 or any(getattr(src, "effectful", False)
                        for src in sources))

        def _logical(pos: int) -> int:
            logical = getattr(sources[pos], "logical_index", None)
            return pos if logical is None else logical

        def _gen():
            pending: dict[int, Future] = {}
            next_to_submit = 0
            next_to_yield = 0
            n = len(sources)
            try:
                while next_to_yield < n:
                    while (next_to_submit < n
                           and len(pending) < box[0]):
                        pending[next_to_submit] = self._pool.submit(
                            self._run_partition, sources[next_to_submit],
                            plan, next_to_submit)
                        next_to_submit += 1
                    fut = pending.pop(next_to_yield)
                    yield _logical(next_to_yield), fut.result()
                    next_to_yield += 1
            finally:
                for fut in pending.values():
                    fut.cancel()
                if drain:
                    _quiesce(pending.values())

        return _gen()

    # -- stream phase (consumer thread) --------------------------------------

    def _apply_stream_stage(self, stage, batch: Batch, index: int) -> Batch:
        """One stage call on the consumer thread, with the pooled path's
        retry semantics (the input block is already materialized and
        stage fns are pure, so a retry re-runs only the call)."""
        def once():
            if stage.kind == "device":
                with self._device_lock:
                    return self._run_stage(stage, batch, index)
            return self._run_stage(stage, batch, index)

        return self.retry_policy.call(
            once, key=f"stream:{stage.name}",
            on_retry=self._log_retry(f"stream stage {stage.name}"))

    def _stream_plain(self, stream, stage):
        for idx, batch in stream:
            yield idx, self._apply_stream_stage(stage, batch, idx)

    def _stream_pooled(self, stream, stage):
        """Host stages downstream of a re-chunked device stage, on the
        pool with a bounded ordered window of futures."""
        pending: collections.deque = collections.deque()
        try:
            for idx, batch in stream:
                pending.append((idx, self._pool.submit(
                    self._apply_stream_stage, stage, batch, idx)))
                while len(pending) >= self.max_inflight:
                    i, fut = pending.popleft()
                    yield i, fut.result()
            while pending:
                i, fut = pending.popleft()
                yield i, fut.result()
        finally:
            for _, fut in pending:
                fut.cancel()
            if getattr(stage, "effectful", False):
                _quiesce(fut for _, fut in pending)

    def _stream_rechunk(self, stream, stage, inflight_box=None,
                        max_hint=None):
        """Feed ``stage`` row blocks cut at multiples of its batch_hint
        from the ordered partition stream; re-slice outputs back to the
        original partition boundaries. All full hints available at an
        arrival go in one stage call, so the runner keeps its own
        chunk pipelining; the hint is re-read between blocks."""

        def cur_hint() -> int:
            return max(1, int(stage.batch_hint))

        in_frags: list = []      # un-dispatched input fragments
        in_rows = 0
        out_frags: list = []     # stage outputs not yet re-sliced
        out_rows = 0
        segs: collections.deque = collections.deque()  # (idx, nrows, out)

        def run_rows(total: int):
            # a whole fragment that is itself a hint multiple goes as
            # it is (a view, no concatenation); only misaligned spans
            # concatenate
            nonlocal in_rows, out_rows
            hint = cur_hint()
            while total:
                rows = _num_rows(in_frags[0])
                n = rows if 0 < rows <= total and rows % hint == 0 \
                    else total
                chunk = _take_rows(in_frags, n)
                in_rows -= n
                total -= n
                out = self._apply_stream_stage(stage, chunk, -1)
                if _num_rows(out) != n:
                    raise RuntimeError(
                        f"stage {stage.name!r} declared row_preserving "
                        f"but returned {_num_rows(out)} rows for {n}")
                out_frags.append(out)
                out_rows += n

        def ready():
            nonlocal out_rows
            while segs:
                idx, nrows, out = segs[0]
                if out is None:
                    if out_rows < nrows:
                        return
                    out = _take_rows(out_frags, nrows)
                    out_rows -= nrows
                segs.popleft()
                yield idx, out

        for idx, batch in stream:
            rows = _num_rows(batch)
            if inflight_box is not None and rows:
                # first real partition: widen the prefix window to cover
                # ~2 device chunks of partitions this size (widen only)
                need = -(-2 * int(max_hint or cur_hint()) // rows)
                inflight_box[0] = max(inflight_box[0], min(16, need))
                inflight_box = None
            if rows == 0:
                # an empty partition keeps its columns by running the
                # stage on it directly (the runner short-circuits N=0)
                segs.append((idx, 0,
                             self._apply_stream_stage(stage, batch, idx)))
            else:
                segs.append((idx, rows, None))
                in_frags.append(batch)
                in_rows += rows
                hint = cur_hint()
                if in_rows >= hint:
                    run_rows((in_rows // hint) * hint)
            yield from ready()
        if in_rows:
            run_rows(in_rows)  # final partial block; the stage pads it
        yield from ready()
        assert not segs, "re-chunk bookkeeping leaked partitions"

    def shutdown(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
        with self._pipeline_lock:
            pipeline, self._pipeline = self._pipeline, None
        if pipeline is not None:
            pipeline.shutdown()


def _quiesce(futures) -> None:
    """Wait out in-flight effectful work before control returns (a
    running task cannot be cancelled); the primary error is already
    propagating, so a secondary one is logged, not raised."""
    for fut in futures:
        if not fut.cancelled():
            try:
                fut.result()
            except Exception as drain_err:
                logger.debug("quiesce drain error: %s", drain_err)


_default: Optional[LocalEngine] = None
_default_lock = threading.Lock()


def default_engine() -> LocalEngine:
    global _default
    with _default_lock:
        if _default is None:
            _default = LocalEngine()
        return _default


def set_default_engine(engine: LocalEngine):
    global _default
    with _default_lock:
        _default = engine
