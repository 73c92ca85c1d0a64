"""Streaming collect: :meth:`DataFrame.collect`'s concatenation done
while the pass's batches arrive.

A pass whose row count is known before it runs (every source counts its
rows and every stage preserves them: ``DataFrame.known_count``) takes
its layout from its first non-empty batch: each fixed-width column's
dtype and row shape, which is what the end's concatenation would give
when the pieces agree. When those columns hold at least
:data:`STREAM_MIN_BYTES` over the pass's rows, a helper thread
allocates them and touches their pages, so they fault while the
consumer thread goes back to the stream (on a device plan, to send the
next chunk to the card) and not at the pass end, and the helpers copy
each batch into its row range as it arrives. :meth:`StreamedConcat.finish`
waits only for the copies still in flight: the last batch's, split in
row slabs over the helpers.

The result is what ``frame.py::concat_batches`` gives for the kept
batches: the same keys in the same order, dtypes and values, and a
:class:`TensorColumn` exactly when every piece is one. A column whose
piece has another dtype, row shape, array class or memory order than
the first, or a pass whose rows differ from the count, falls back to
:func:`concat_columns` of its kept pieces. Object columns, and every
pass that does not stream, concatenate at the end as before.

The registry counts each pass once by route, ``frame.collect.streamed``
or ``frame.collect.concatenated``, and the streamed columns that fell
back, ``frame.collect.fallback_columns``. Armed, the pass's
``frame.concat`` span covers only its end, the wait and whatever is
concatenated there: ``rows`` and ``bytes`` of the kept batches,
``streamed``, and ``tail_bytes``, the bytes the end still had to copy
when it began (on the concatenated route, every byte).
"""

from __future__ import annotations

import math
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from sparkdl_tpu_torch.data.tensors import Batch, TensorColumn, concat_columns

#: the least fixed-width bytes a pass streams. Below it the helper
#: threads' start and the hand-off of each batch cost about what
#: overlapping a copy of a few MB with the stream saves.
STREAM_MIN_BYTES = 4 << 20

#: helper threads of one pass: on a short pass of many batches (ResNet50
#: at batch 256 streams 411 MB in 8 batches within about 0.3 s) one
#: thread falls behind the stream, so several batches copy at once
COPY_THREADS = 4

#: a slab's least bytes: the last batch's copy, the one the pass end
#: waits for, splits in at most COPY_THREADS slabs of at least this size
SLAB_MIN_BYTES = 1 << 20

#: pages are touched one byte a page, in slices of this many bytes
#: between checks that the pass is still running
_TOUCH_BYTES = 64 << 20
_PAGE = 4096

Layout = Dict[str, Tuple[np.dtype, Tuple[int, ...]]]


def _streamable(col) -> bool:
    """Whether a column's pieces concatenate to its own dtype (not an
    object, not a byte-swapped one)."""
    if not isinstance(col, np.ndarray) or col.dtype.hasobject:
        return False
    return np.concatenate([col[:0], col[:0]]).dtype == col.dtype


class StreamedConcat:
    """One pass of ``rows`` rows (None when unknown, and then it never
    streams): :meth:`add` each batch as it arrives, :meth:`finish` with
    the kept batches when :attr:`streaming`, and :meth:`close` always
    (it cancels what is queued and joins the helpers)."""

    def __init__(self, rows: Optional[int]):
        self._rows = rows
        self._placed = 0
        self._layout: Optional[Layout] = None
        self._ok: Dict[str, bool] = {}
        self._pool: Optional[ThreadPoolExecutor] = None
        self._bufs: Optional[Future] = None
        self._copies: List[Tuple[Future, int]] = []  # (future, bytes)
        self._closed = threading.Event()

    @property
    def streaming(self) -> bool:
        return self._pool is not None

    def _start(self, batch: Batch) -> None:
        self._layout = {k: (v.dtype, tuple(v.shape[1:]))
                        for k, v in batch.items() if _streamable(v)}
        row_bytes = sum(dt.itemsize * math.prod(shape)
                        for dt, shape in self._layout.values())
        if (self._rows or 0) * row_bytes < STREAM_MIN_BYTES:
            return
        self._ok = dict.fromkeys(self._layout, True)
        self._pool = ThreadPoolExecutor(COPY_THREADS,
                                        thread_name_prefix="frame.collect")
        self._bufs = self._pool.submit(self._allocate)

    def _allocate(self) -> Dict[str, np.ndarray]:
        bufs = {k: np.empty((self._rows,) + shape, dt)
                for k, (dt, shape) in self._layout.items()}
        for buf in bufs.values():
            flat = buf.reshape(-1).view(np.uint8)
            for lo in range(0, flat.size, _TOUCH_BYTES):
                if self._closed.is_set():
                    return bufs
                flat[lo:lo + _TOUCH_BYTES:_PAGE] = 0
        return bufs

    def _copy(self, pieces: Batch, at: int, lo: int, hi: int) -> None:
        bufs = self._bufs.result()
        for k, piece in pieces.items():
            bufs[k][at + lo:at + hi] = piece[lo:hi]

    def _fits(self, k: str, piece) -> bool:
        dt, shape = self._layout[k]
        return (type(piece) in (np.ndarray, TensorColumn)
                and piece.dtype == dt and piece.shape[1:] == shape
                and (piece.ndim < 2 or piece.flags.c_contiguous))

    def add(self, batch: Batch) -> None:
        """Queue the copy of a batch's streamed columns into their row
        range; a zero-row batch is skipped, as collect drops it."""
        n = len(next(iter(batch.values()))) if batch else 0
        if not n:
            return
        if self._layout is None:
            self._start(batch)
        if not self.streaming:
            return
        at, self._placed = self._placed, self._placed + n
        if self._placed > self._rows:
            self._ok = dict.fromkeys(self._ok, False)
            return
        pieces = {}
        for k, ok in self._ok.items():
            if ok and self._fits(k, batch.get(k)):
                pieces[k] = batch[k]
            else:
                self._ok[k] = False
        if not pieces:
            return
        nbytes = sum(int(p.nbytes) for p in pieces.values())
        slabs = (max(1, min(COPY_THREADS, n, nbytes // SLAB_MIN_BYTES))
                 if self._placed == self._rows else 1)
        cuts = np.linspace(0, n, slabs + 1).astype(int)
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            self._copies.append((
                self._pool.submit(self._copy, pieces, at, int(lo), int(hi)),
                nbytes * int(hi - lo) // n))

    def _kept(self, k: str) -> bool:
        return self._ok.get(k, False) and self._placed == self._rows

    def tail_bytes(self, parts: List[Batch]) -> int:
        """Bytes the pass end still has to copy: the streamed copies not
        yet done, and every column it concatenates (every byte of a pass
        that does not stream)."""
        late = sum(b for fut, b in self._copies if not fut.done())
        return late + sum(int(getattr(v, "nbytes", 0))
                          for b in parts for k, v in b.items()
                          if not self._kept(k))

    def finish(self, parts: List[Batch]) -> Tuple[Batch, int]:
        """The pass's batch from its kept batches (``parts``, as collect
        keeps them) and the number of streamed columns that fell back
        to :func:`concat_columns`. Raises what a copy raised."""
        for fut, _ in self._copies:
            fut.result()
        bufs = self._bufs.result()
        out, fallback = {}, 0
        for k in parts[0]:
            if self._kept(k):
                buf = bufs[k]
                if all(isinstance(b[k], TensorColumn) for b in parts):
                    buf = buf.view(TensorColumn)
                out[k] = buf
            else:
                fallback += k in self._ok
                out[k] = concat_columns([b[k] for b in parts])
        return out, fallback

    def close(self) -> None:
        self._closed.set()
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
