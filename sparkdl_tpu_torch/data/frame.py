"""Immutable partitioned frame over numpy batches — counterpart of
``sparkdl_tpu/data/frame.py``, verb for verb.

A partition is a :class:`Source` that loads one batch (an ordered dict
of column → ndarray); a frame is its sources plus a plan of
batch → batch stages, run lazily by its engine
(``data/engine.py::LocalEngine``, the default engine unless the frame
was given one) when the frame is collected. Batches are not Arrow:
strings and image structs are object arrays, tensor columns are
``[N, *shape]`` arrays. A frame's "schema" is a zero-row prototype
batch: the column names in order, each an empty array of the column's
dtype and row shape. Only the Arrow and pandas verbs (``from_table``,
``from_pandas``, ``to_pandas``, ``read_parquet``, ``write_parquet``)
import pyarrow or pandas, inside the verb (``data/arrow.py``), and
their parquet layout is the JAX package's: one part file a partition,
``_SUCCESS``, the JAX package's Arrow columns.

The sources and stages the frame builds itself are module-level
callables (small frozen dataclasses with ``__call__``), not closures, so
a plan ships to the host pipeline's worker processes and to a decode
fleet with the standard library's ``pickle``; a user's own lambda
in ``map_batches`` stays as given, and the pipeline then takes its
counted thread fallback.

:meth:`DataFrame.collect` streams a pass whose row count is known
before it runs (``data/collect.py``): its fixed-width columns are copied
into place as the batches arrive, off the consumer thread; every other
pass concatenates its batches at the end. The registry counts passes by
route (``frame.collect.streamed``, ``frame.collect.concatenated``) and
the streamed columns that fell back (``frame.collect.fallback_columns``).
Armed (``obs/trace.py``), collect records a ``frame.collect`` span
around the whole pass and a ``frame.concat`` span (``rows``, ``bytes``,
``streamed``, ``tail_bytes``) around the end's wait and copy, both on
the ``engine`` lane.
"""

from __future__ import annotations

import collections
import dataclasses
import glob
import json
import logging
import os
import shutil
import threading
import uuid
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.data.collect import StreamedConcat
from sparkdl_tpu_torch.data.tensors import (
    Batch,
    TensorColumn,
    column_to_tensor,
    column_values,
    concat_columns,
)
from sparkdl_tpu_torch.obs.registry import default_registry
from sparkdl_tpu_torch.obs.trace import span, tracer

logger = logging.getLogger(__name__)


class LiveBatchHint:
    """A ``Stage.batch_hint`` that follows its runner's
    ``preferred_chunk`` live instead of freezing the value at plan
    build. The engine reads hints through ``int(...)`` / ``bool(...)``
    (``LocalEngine._stream_rechunk`` re-reads between blocks), so a
    runner whose device batch moves pulls the engine's re-chunk cut
    along with it. Duck-typed: anything with a ``preferred_chunk``
    attribute works."""

    __slots__ = ("runner",)

    def __init__(self, runner):
        self.runner = runner

    def __int__(self) -> int:
        return int(self.runner.preferred_chunk)

    __index__ = __int__

    def __bool__(self) -> bool:
        return int(self.runner.preferred_chunk) > 0

    def __repr__(self) -> str:
        return f"LiveBatchHint({int(self)})"


@dataclasses.dataclass(frozen=True)
class Stage:
    """One plan step: batch → batch. With ``with_index``,
    ``fn(batch, partition_index)``.

    ``kind``: ``"host"`` stages run on the engine's thread pool,
    ``"device"`` stages one at a time behind the engine's device lock.
    ``batch_hint`` (device stages): the stage's preferred input row
    count — its device batch. A row-preserving, index-free device stage
    with a hint may be re-chunked by the engine: fed row blocks cut at
    multiples of the hint from the ordered partition stream instead of
    per-partition blocks, so partitions smaller than the device batch
    stop padding up to it. ``effectful`` marks a stage with externally
    visible side effects: on error or abandonment the engine then
    drains in-flight siblings before returning control."""
    fn: Callable[..., Batch]
    kind: str = "host"            # "host" (thread-parallel) | "device" (serial)
    name: str = "stage"
    row_preserving: bool = True
    with_index: bool = False
    batch_hint: Optional[int] = None
    effectful: bool = False


@dataclasses.dataclass(frozen=True)
class Source:
    """One partition: ``load`` materializes its batch; ``num_rows`` is a
    count known without loading (None = unknown). ``logical_index``,
    when set, is the partition's identity for ``with_index`` stages
    (None = its position), so reordering partitions
    (``with_partition_order``) never changes what a seeded stage draws
    for one. ``schema_hint``, when set, is a zero-row prototype equal to
    ``load()``'s columns: ``DataFrame.schema`` then runs the plan on it
    without loading the partition. ``effectful`` marks a ``load`` with
    side effects (``cache_to_disk`` spills write in it): the engine then
    quiesces in-flight sibling loads before returning control on error
    or abandonment."""
    load: Callable[[], Batch]
    num_rows: Optional[int] = None
    logical_index: Optional[int] = None
    schema_hint: Optional[Batch] = dataclasses.field(default=None,
                                                     compare=False)
    effectful: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class ConstantLoad:
    """A source's ``load`` that returns one batch held in memory."""
    batch: Batch

    def __call__(self) -> Batch:
        return self.batch


@dataclasses.dataclass(frozen=True, eq=False)
class FilterRows:
    """The ``filter`` stage: keeps the rows where ``predicate(batch)``,
    a bool mask, holds."""
    predicate: Callable[[Batch], np.ndarray]

    def __call__(self, batch: Batch) -> Batch:
        mask = np.asarray(self.predicate(batch), dtype=bool)
        return {k: v[mask] for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class SelectColumns:
    """The ``select`` stage: these columns, in this order."""
    cols: tuple

    def __call__(self, batch: Batch) -> Batch:
        return {c: column(batch, c) for c in self.cols}


@dataclasses.dataclass(frozen=True)
class DropColumns:
    """The ``drop`` stage: every column but these."""
    cols: frozenset

    def __call__(self, batch: Batch) -> Batch:
        return {k: v for k, v in batch.items() if k not in self.cols}


@dataclasses.dataclass(frozen=True, eq=False)
class WithColumn:
    """The ``with_column`` stage: ``fn(batch)``'s column added, or
    replacing a column of that name in its position. A 1-D numeric
    result is a :class:`~sparkdl_tpu_torch.data.tensors.TensorColumn`,
    a tensor column of row shape ``()`` as in the JAX package."""
    name: str
    fn: Callable[[Batch], np.ndarray]

    def __call__(self, batch: Batch) -> Batch:
        col = self.fn(batch)
        if not isinstance(col, np.ndarray):
            col = to_column(list(col))
        elif col.ndim == 1 and col.dtype.kind in "biuf":
            col = col.view(TensorColumn)
        if len(col) != num_rows(batch) and batch:
            raise ValueError(
                f"with_column({self.name!r}) returned {len(col)} rows for "
                f"a batch of {num_rows(batch)}")
        out = dict(batch)
        out[self.name] = col
        return out


def _check_rename(mapping: dict, names) -> None:
    """A rename that would make two columns share a name raises (a numpy
    batch cannot hold both; the JAX package refuses the same)."""
    before = collections.Counter(names)
    after = collections.Counter(mapping.get(n, n) for n in names)
    dup = sorted(n for n, c in after.items() if c > 1 and c > before[n])
    if dup:
        raise ValueError(
            f"rename would duplicate column name(s) {dup}; drop the "
            "existing column first")


@dataclasses.dataclass(frozen=True)
class RenameColumns:
    """The ``rename`` stage; ``validate`` checks each batch's names when
    the schema was not free to check at plan time."""
    mapping: tuple
    validate: bool

    def __call__(self, batch: Batch) -> Batch:
        mapping = dict(self.mapping)
        if self.validate:
            _check_rename(mapping, list(batch))
        return {mapping.get(k, k): v for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class SampleRows:
    """The ``sample`` stage: a Bernoulli draw per row from
    ``default_rng((seed, partition))``, the JAX package's generator, so
    both draw the same rows."""
    fraction: float
    seed: int

    def __call__(self, batch: Batch, index: int) -> Batch:
        rng = np.random.default_rng((self.seed, index))
        keep = rng.random(num_rows(batch)) < self.fraction
        return {k: v[keep] for k, v in batch.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class SliceLoad:
    """A ``limit`` partition's ``load``: its source's first rows."""
    load: Callable[[], Batch]
    rows: int

    def __call__(self) -> Batch:
        return {k: v[:self.rows] for k, v in self.load().items()}


def _run_source(engine, plan, source: "Source", j: int) -> Batch:
    """One source through a plan: the engine's retrying, device-locked
    partition runner when it has one, else the plain stage contract
    (a shipped copy, whose engine stayed behind)."""
    runner = getattr(engine, "_run_partition", None)
    if runner is not None:
        return runner(source, plan, j)
    idx = source.logical_index if source.logical_index is not None else j
    return apply_plan(plan, source.load(), idx)


class DeferredSide:
    """One side of a different-plan ``union``, materialized once per
    process, on a private pool of at most 4 threads (the engine's own
    pool may be the caller's), each partition through the engine's
    partition runner. Pickled, it drops its engine, lock and batches: a
    shipped copy computes only the partition its task asks for."""

    def __init__(self, engine, plan, sources):
        self._engine = engine
        self._plan = list(plan)
        self._sources = list(sources)
        self._lock = threading.Lock()
        self._batches: Optional[List[Batch]] = None

    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        state["_batches"] = None
        state["_engine"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _run(self, s: "Source", j: int) -> Batch:
        return _run_source(self._engine, self._plan, s, j)

    def get(self, i: int) -> Batch:
        if self._engine is None:
            # sparkdl-lint: allow[H17] -- _sources is immutable after __init__ (bound once, never rebound/mutated); the lock guards the _batches memoization, the source list just rides inside it
            return self._run(self._sources[i], i)
        with self._lock:
            if self._batches is None:
                from concurrent.futures import ThreadPoolExecutor
                n_workers = min(4, max(1, len(self._sources)))
                with ThreadPoolExecutor(
                        max_workers=n_workers,
                        thread_name_prefix="sparkdl-torch-union") as pool:
                    self._batches = list(pool.map(
                        self._run, self._sources,
                        range(len(self._sources))))
            return self._batches[i]


@dataclasses.dataclass(frozen=True, eq=False)
class SideLoad:
    """A deferred union partition's ``load``."""
    side: DeferredSide
    index: int

    def __call__(self) -> Batch:
        return self.side.get(self.index)


class CoalescedGroup:
    """One ``coalesce`` output partition: its input partitions through
    the plan one at a time (the engine's partition runner, so device
    stages stay serialized; each keeps its logical index), then
    concatenated. Pickled, it drops its engine."""

    def __init__(self, engine, plan, sources, base_index: int,
                 schema: Batch):
        self._engine = engine
        self._plan = list(plan)
        self._sources = list(sources)
        self._base = base_index
        self._schema = schema

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_engine"] = None
        return state

    def __call__(self) -> Batch:
        batches = [b for off, src in enumerate(self._sources)
                   for b in [_run_source(self._engine, self._plan, src,
                                         self._base + off)]
                   if num_rows(b)]
        if not batches:
            return dict(self._schema)
        return concat_batches(batches)


@dataclasses.dataclass(frozen=True, eq=False)
class JoinProbe:
    """The ``join`` stage: each row's key looked up in the broadcast
    right side; ``inner`` keeps the matched rows, ``left`` keeps every
    row with None payload where none matched."""
    keys: tuple
    how: str
    index: dict       # key → right row
    payload: dict     # right columns less the keys

    def __call__(self, batch: Batch) -> Batch:
        keys = _key_values(batch, self.keys)
        pos = np.array([self.index.get(k, -1) if k is not None else -1
                        for k in keys], dtype=np.int64)
        matched = pos >= 0
        if self.how == "inner":
            batch = {k: v[matched] for k, v in batch.items()}
            pos = pos[matched]
            matched = matched[matched]
        out = dict(batch)
        for name, col in self.payload.items():
            if matched.all():
                out[name] = col[pos]
            else:
                out[name] = to_column([col[p] if p >= 0 else None
                                       for p in pos])
        return out


def _key_values(batch: Batch, keys) -> list:
    """Each row's join key: the value of one key column, or a tuple of
    several (None where any part is None)."""
    cols = [column_values(column(batch, k)).tolist() for k in keys]
    if len(cols) == 1:
        return cols[0]
    return [None if any(v is None for v in row) else tuple(row)
            for row in zip(*cols)]


@dataclasses.dataclass(frozen=True)
class WriteParquetPart:
    """``write_parquet``'s stage, run inside the task: the partition's
    rows written as one part file into the staging directory (a
    temporary name, then ``os.replace``; a name unique to the attempt),
    and a one-row summary of it returned in their place."""
    staging: str
    row_group_rows: Optional[int]

    def __call__(self, batch: Batch, index: int) -> Batch:
        if not num_rows(batch):
            return {"part": to_column([]),
                    "rows": np.zeros(0, np.int64)}
        from sparkdl_tpu_torch.data import arrow
        pa = arrow.require("pyarrow", "write_parquet")
        pq = arrow.require("pyarrow.parquet", "write_parquet")
        os.makedirs(self.staging, exist_ok=True)
        fname = f"part-{index:05d}-{uuid.uuid4().hex[:8]}.parquet"
        tmp = os.path.join(
            self.staging,
            f"{fname}.tmp.{os.getpid()}.{threading.get_ident()}")
        kw = ({"row_group_size": int(self.row_group_rows)}
              if self.row_group_rows else {})
        pq.write_table(pa.Table.from_batches([arrow.batch_to_arrow(batch)]),
                       tmp, **kw)
        os.replace(tmp, os.path.join(self.staging, fname))
        return {"part": to_column([fname]),
                "rows": np.array([num_rows(batch)], np.int64)}


@dataclasses.dataclass(frozen=True)
class ParquetPartLoad:
    """A ``read_parquet`` partition's ``load``: one part file."""
    path: str

    def __call__(self) -> Batch:
        from sparkdl_tpu_torch.data import arrow
        pq = arrow.require("pyarrow.parquet", "read_parquet")
        return arrow.arrow_to_batch(pq.read_table(self.path))


@dataclasses.dataclass(frozen=True)
class SpillPart:
    """``repartition(cacheDir=)``'s stage, run inside the task: the
    partition's rows spilled as one file of the numpy batch codec
    (``data/codec.py``) and a one-row summary returned."""
    directory: str

    def __call__(self, batch: Batch, index: int) -> Batch:
        from sparkdl_tpu_torch.data.codec import encode_batch
        fname = f"part-{index:05d}-{uuid.uuid4().hex[:8]}.sdnb"
        path = os.path.join(self.directory, fname)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(encode_batch(batch))
        os.replace(tmp, path)
        return {"part": to_column([fname]),
                "rows": np.array([num_rows(batch)], np.int64)}


@dataclasses.dataclass(frozen=True)
class SpillRangeLoad:
    """A ``repartition(cacheDir=)`` output partition's ``load``: rows
    ``[lo, hi)`` of the spill, reading only the files they overlap."""
    files: tuple      # (path, first row, rows)
    lo: int
    hi: int
    schema: Batch = dataclasses.field(compare=False)

    def __call__(self) -> Batch:
        from sparkdl_tpu_torch.data.codec import decode_batch
        frags = []
        for path, first, rows in self.files:
            a, z = max(self.lo, first), min(self.hi, first + rows)
            if a >= z:
                continue
            with open(path, "rb") as f:
                part = decode_batch(bytearray(f.read()))
            frags.append({k: v[a - first:z - first]
                          for k, v in part.items()})
        if not frags:
            return dict(self.schema)
        return concat_batches(frags)


def column(batch: Batch, name: str) -> np.ndarray:
    """A batch's column by name, with an error that lists the columns."""
    if name not in batch:
        raise KeyError(f"no column {name!r}; columns are {list(batch)}")
    return batch[name]


def to_column(values: Sequence) -> np.ndarray:
    """Row values → a column: numeric scalars become a numeric array,
    anything else (strings, dicts, arrays, None) an object array."""
    if all(isinstance(v, (bool, int, float, np.number)) for v in values) \
            and len(values):
        return np.asarray(values)
    col = np.empty(len(values), dtype=object)
    col[:] = list(values)
    return col


def concat_batches(batches: List[Batch]) -> Batch:
    if not batches:
        return {}
    return {k: concat_columns([b[k] for b in batches])
            for k in batches[0]}


def _concat_pass(parts: List[Batch], streamed: StreamedConcat) -> Batch:
    """A pass's batch from its kept batches, counted by route."""
    reg = default_registry()
    if not streamed.streaming:
        reg.counter("frame.collect.concatenated").add(1)
        return concat_batches(parts)
    reg.counter("frame.collect.streamed").add(1)
    out, fallback = streamed.finish(parts)
    if fallback:
        reg.counter("frame.collect.fallback_columns").add(fallback)
    return out


def num_rows(batch: Batch) -> int:
    return len(next(iter(batch.values()))) if batch else 0


def prototype(batch: Batch) -> Batch:
    """The zero-row prototype of a batch (same columns, dtypes, row
    shapes)."""
    return {k: v[:0] for k, v in batch.items()}


def apply_plan(plan: Sequence[Stage], batch: Batch, index: int) -> Batch:
    """Run a plan's stages on one batch, outside any engine."""
    for stage in plan:
        batch = (stage.fn(batch, index) if stage.with_index
                 else stage.fn(batch))
    return batch


class DataFrame:
    """Immutable partitioned frame; transforms return new frames."""

    def __init__(self, sources: Sequence[Source],
                 plan: Sequence[Stage] = (), engine=None):
        from sparkdl_tpu_torch.data.engine import default_engine
        self._sources: List[Source] = list(sources)
        self._plan: List[Stage] = list(plan)
        self._engine = engine or default_engine()
        self._schema: Optional[Batch] = None

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_columns(columns: Batch, num_partitions: int = 8,
                     engine=None) -> "DataFrame":
        """One batch of columns split into up to ``num_partitions``
        contiguous row ranges."""
        n = num_rows(columns)
        num_partitions = max(1, min(num_partitions, n) if n else 1)
        bounds = np.linspace(0, n, num_partitions + 1).astype(int)
        hint = prototype(columns)
        sources = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            part = {k: v[lo:hi] for k, v in columns.items()}
            sources.append(Source(ConstantLoad(part), int(hi - lo),
                                  schema_hint=hint))
        return DataFrame(sources, engine=engine)

    @staticmethod
    def from_pylist(rows: List[dict], num_partitions: int = 8,
                    engine=None) -> "DataFrame":
        names: List[str] = []
        for row in rows:
            names += [k for k in row if k not in names]
        columns = {k: to_column([row.get(k) for row in rows])
                   for k in names}
        return DataFrame.from_columns(columns, num_partitions, engine)

    @staticmethod
    def from_batches(batches: Sequence[Batch],
                     engine=None) -> "DataFrame":
        """One partition per numpy batch, in order."""
        return DataFrame([Source(ConstantLoad(b), num_rows(b),
                                 schema_hint=prototype(b))
                          for b in batches], engine=engine)

    @staticmethod
    def from_table(table, num_partitions: int = 8,
                   engine=None) -> "DataFrame":
        """A ``pyarrow.Table`` (the JAX package's layout,
        ``data/arrow.py``) split into up to ``num_partitions`` contiguous
        row ranges, as the JAX package's ``from_table``."""
        from sparkdl_tpu_torch.data import arrow
        return DataFrame.from_columns(arrow.arrow_to_batch(table),
                                      num_partitions, engine)

    @staticmethod
    def from_pandas(df, num_partitions: int = 8,
                    engine=None) -> "DataFrame":
        """A pandas ``DataFrame``, through ``pyarrow.Table.from_pandas``
        as in the JAX package."""
        from sparkdl_tpu_torch.data import arrow
        return DataFrame.from_table(arrow.table_from_pandas(df),
                                    num_partitions, engine)

    @staticmethod
    def read_parquet(path: str, engine=None,
                     allow_uncommitted: bool = False) -> "DataFrame":
        """A lazy frame over a parquet directory (one partition a part
        file, sorted by name) or one file, with the JAX package's
        commit rules: part files beside a ``_tmp.*`` staging remnant and
        no ``_SUCCESS`` are an interrupted write and raise
        ``FileNotFoundError`` unless ``allow_uncommitted``; part files
        without ``_SUCCESS`` and without a remnant (another writer) are
        read with a warning. Row counts and the schema come from the
        footers, so planning reads no data."""
        from sparkdl_tpu_torch.data import arrow
        pq = arrow.require("pyarrow.parquet", "read_parquet")
        if os.path.isdir(path):
            files = sorted(glob.glob(os.path.join(path, "*.parquet")))
            if files and not os.path.exists(
                    os.path.join(path, "_SUCCESS")):
                staging = glob.glob(os.path.join(path, "_tmp.*"))
                if staging and not allow_uncommitted:
                    raise FileNotFoundError(
                        f"{path!r} holds part files, no _SUCCESS "
                        f"marker, and a staging remnant "
                        f"({os.path.basename(staging[0])}): a "
                        "write_parquet was interrupted mid-commit and "
                        "the dataset may be PARTIAL. Pass "
                        "allow_uncommitted=True to read it anyway.")
                logger.warning(
                    "%r has no _SUCCESS marker%s: serving a dataset "
                    "this library did not commit; its completeness "
                    "cannot be verified (touch _SUCCESS to silence "
                    "this warning).", path,
                    " and a _tmp.* staging remnant" if staging else "")
        else:
            files = [path]
        if not files:
            raise FileNotFoundError(f"no .parquet files under {path!r}")
        sources, schema = [], None
        for f in files:
            pf = pq.ParquetFile(f)
            if schema is None:
                schema = pf.schema_arrow
            sources.append(Source(ParquetPartLoad(f),
                                  pf.metadata.num_rows))
        out = DataFrame(sources, engine=engine)
        # the footer's schema: the default probe would read a part
        out._schema = arrow.prototype_from_schema(schema)
        return out

    def write_parquet(self, path: str,
                      row_group_rows: Optional[int] = None) -> str:
        """Run the plan and write one parquet part file a partition
        under ``path``, in the JAX package's layout. Each task writes
        its part into a staging directory (``_tmp.<pid>``) and returns
        only a summary, so on ``SparkEngine`` the parts are written
        inside the tasks; the driver then renames them into place in
        partition order (``part-00000.parquet``, ...) and writes
        ``_SUCCESS``. A failure before the first rename sweeps the
        staging directory; after it, the remnant marks the dataset as
        interrupted. A directory that already holds part files or a
        staging remnant raises ``FileExistsError``. Returns ``path``."""
        from sparkdl_tpu_torch.data import arrow
        pq = arrow.require("pyarrow.parquet", "write_parquet")
        os.makedirs(path, exist_ok=True)
        if glob.glob(os.path.join(path, "*.parquet")):
            raise FileExistsError(
                f"{path!r} already holds parquet part files; write to "
                "a fresh directory (overwrite is never implicit)")
        stale = glob.glob(os.path.join(path, "_tmp.*"))
        if stale:
            raise FileExistsError(
                f"{path!r} holds staging leftovers ({stale[0]}): "
                "another write_parquet is in progress, or a previous "
                "one was killed mid-stream — delete the _tmp.* "
                "directory if no writer is running")
        staging = os.path.join(path, f"_tmp.{os.getpid()}")
        os.makedirs(staging)
        committed = 0
        try:
            entries = []
            for b in self.map_batches(
                    WriteParquetPart(staging, row_group_rows),
                    name="write_parquet", row_preserving=False,
                    with_index=True, effectful=True).stream():
                entries += list(zip(column(b, "part"), column(b, "rows")))
            if not entries:
                # an all-empty frame: one empty part, so its schema
                # round-trips
                f = os.path.join(staging, "part-empty.parquet")
                pa = arrow.require("pyarrow", "write_parquet")
                pq.write_table(pa.Table.from_batches(
                    [arrow.batch_to_arrow(self.schema)]), f)
                entries = [("part-empty.parquet", 0)]
            for seq, (part, _rows) in enumerate(entries):
                os.replace(os.path.join(staging, part),
                           os.path.join(path, f"part-{seq:05d}.parquet"))
                committed += 1
            with open(os.path.join(path, "_SUCCESS"), "w"):
                pass
        except BaseException:
            if not committed:
                shutil.rmtree(staging, ignore_errors=True)
            raise
        shutil.rmtree(staging, ignore_errors=True)
        return path

    # -- plan building ------------------------------------------------------

    def map_batches(self, fn: Callable[..., Batch],
                    kind: str = "host", name: str = "map_batches",
                    row_preserving: bool = True,
                    with_index: bool = False,
                    batch_hint: Optional[int] = None,
                    effectful: bool = False) -> "DataFrame":
        return DataFrame(
            self._sources,
            self._plan + [Stage(fn, kind, name, row_preserving,
                                with_index, batch_hint, effectful)],
            self._engine)

    def with_column(self, name: str, fn: Callable[[Batch], np.ndarray],
                    kind: str = "host") -> "DataFrame":
        """Add a column computed per batch by ``fn(batch)`` (an array,
        or row values), or replace the column of that name in its
        position (pyspark ``withColumn``)."""
        if not callable(fn):
            raise TypeError(
                f"with_column({name!r}) needs a per-batch function "
                f"(batch -> column), got {type(fn).__name__}; a literal "
                "column can't be appended lazily — partitions stream, "
                "so compute it from each batch (e.g. from a key column)")
        return self.map_batches(WithColumn(name, fn), kind=kind,
                                name=f"with_column({name})")

    def rename(self, mapping: dict) -> "DataFrame":
        """Rename columns (``{old: new}``). A rename that would make two
        columns share a name raises ``ValueError``: at plan time when
        the schema is free, else at each batch."""
        mapping = dict(mapping)
        free = self.schema_probe_free
        if free:
            _check_rename(mapping, list(self.schema))
        return self.map_batches(
            RenameColumns(tuple(mapping.items()), not free), name="rename")

    def filter(self, predicate: Callable[[Batch], np.ndarray]
               ) -> "DataFrame":
        """Keep the rows where ``predicate(batch)`` (a bool mask) holds."""
        return self.map_batches(FilterRows(predicate), name="filter",
                                row_preserving=False)

    def select(self, *cols: str) -> "DataFrame":
        return self.map_batches(SelectColumns(tuple(cols)),
                                name=f"select({','.join(cols)})")

    def drop(self, *cols: str) -> "DataFrame":
        return self.map_batches(DropColumns(frozenset(cols)),
                                name=f"drop({','.join(cols)})")

    def with_partition_order(self, indices: Sequence[int]) -> "DataFrame":
        """A frame over the given subset or permutation of this frame's
        partitions, same plan; each partition keeps its logical index
        (per-epoch partition shuffles of a streaming fit)."""
        n = len(self._sources)
        indices = [int(i) for i in indices]
        bad = [i for i in indices if not (0 <= i < n)]
        if bad:
            raise IndexError(
                f"partition index {bad[0]} out of range [0, {n})")

        def keep_identity(i: int) -> Source:
            src = self._sources[i]
            if src.logical_index is not None:
                return src
            return dataclasses.replace(src, logical_index=i)

        return DataFrame([keep_identity(i) for i in indices],
                         self._plan, self._engine)

    def filter_rows(self, mask: np.ndarray) -> "DataFrame":
        """Keep the rows where a global boolean mask over the collected
        rows holds (CrossValidator's folds)."""
        batch = self.collect()
        if len(mask) != num_rows(batch):
            raise ValueError(f"mask length {len(mask)} != rows "
                             f"{num_rows(batch)}")
        keep = np.asarray(mask, dtype=bool)
        return DataFrame.from_columns({k: v[keep] for k, v in batch.items()},
                                      max(1, len(self._sources)),
                                      self._engine)

    def repartition(self, num_partitions: int,
                    cacheDir: Optional[str] = None) -> "DataFrame":
        """The same rows in order over ``num_partitions`` partitions.
        Without ``cacheDir`` the frame is collected and re-sliced. With
        it, each task spills its partition under a fresh
        ``repartition_spill_*`` directory of ``cacheDir`` (the numpy
        batch codec; the JAX package spills parquet) and each output
        partition reads only the spill files its row range overlaps,
        so the whole frame is never in memory at once."""
        if int(num_partitions) <= 0:
            raise ValueError(
                f"num_partitions must be positive, got {num_partitions}")
        if cacheDir is None:
            return DataFrame.from_columns(self.collect(),
                                          int(num_partitions),
                                          self._engine)
        spill = os.path.join(cacheDir,
                             f"repartition_spill_{uuid.uuid4().hex[:12]}")
        os.makedirs(spill)
        schema = self.schema
        files, first = [], 0
        for b in self.map_batches(SpillPart(spill), name="spill",
                                  row_preserving=False, with_index=True,
                                  effectful=True).stream():
            for part, rows in zip(column(b, "part"), column(b, "rows")):
                files.append((os.path.join(spill, part), first, int(rows)))
                first += int(rows)
        n_out = max(1, min(int(num_partitions), first) if first else 1)
        bounds = np.linspace(0, first, n_out + 1).astype(int)
        out = DataFrame([Source(SpillRangeLoad(tuple(files), int(lo),
                                               int(hi), schema),
                                int(hi - lo))
                         for lo, hi in zip(bounds[:-1], bounds[1:])],
                        engine=self._engine)
        out._schema = schema
        return out

    def coalesce(self, num_partitions: int) -> "DataFrame":
        """Merge adjacent partitions down to ``num_partitions`` without
        collecting (Spark ``coalesce``): each output partition runs its
        group through the plan one partition at a time, each keeping its
        logical index, and concatenates; row order is kept."""
        if int(num_partitions) <= 0:
            raise ValueError(
                f"num_partitions must be positive, got {num_partitions}")
        n_out = min(int(num_partitions), len(self._sources))
        if n_out == len(self._sources):
            return self
        preserving = all(st.row_preserving for st in self._plan)
        bounds = np.linspace(0, len(self._sources), n_out + 1).astype(int)
        schema = self.schema
        sources = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            group = self._sources[lo:hi]
            rows = (sum(s.num_rows for s in group)
                    if preserving and all(s.num_rows is not None
                                          for s in group) else None)
            sources.append(Source(CoalescedGroup(
                self._engine, self._plan, group, int(lo), schema), rows))
        out = DataFrame(sources, engine=self._engine)
        # the group's load is the plan: a probe would run a whole group
        out._schema = schema
        return out

    def _materialize_prefix(self, n: int) -> "DataFrame":
        """The first ``n`` rows after the plan, as one partition,
        streaming only until they are in."""
        batches: List[Batch] = []
        remaining = n
        if remaining > 0:
            stream = self.stream()
            try:
                for batch in stream:
                    if num_rows(batch) > remaining:
                        batch = {k: v[:remaining]
                                 for k, v in batch.items()}
                    if num_rows(batch):
                        batches.append(batch)
                    remaining -= num_rows(batch)
                    if remaining <= 0:
                        break
            finally:
                close = getattr(stream, "close", None)
                if close is not None:
                    close()
        return DataFrame.from_columns(
            concat_batches(batches) if batches else dict(self.schema), 1,
            self._engine)

    def limit(self, n: int) -> "DataFrame":
        """The first ``n`` rows across partitions, in order; partitions
        past the cut are never loaded. A plan that drops rows, or a
        source of unknown size, makes it collect just enough rows."""
        if n < 0:
            raise ValueError(f"limit must be >= 0, got {n}")
        if any(not st.row_preserving for st in self._plan):
            return self._materialize_prefix(n)
        out_sources: List[Source] = []
        remaining = n
        for s in self._sources:
            if remaining <= 0:
                break
            if s.num_rows is None:
                return self._materialize_prefix(n)
            if s.num_rows <= remaining:
                out_sources.append(s)
                remaining -= s.num_rows
            else:
                # keeps the partition's logical identity for with_index
                # stages (the un-limited frame's draws must be a prefix)
                out_sources.append(dataclasses.replace(
                    s, load=SliceLoad(s.load, remaining),
                    num_rows=remaining))
                remaining = 0
        if not out_sources:
            return DataFrame.from_columns(dict(self.schema), 1,
                                          self._engine)
        return DataFrame(out_sources, self._plan, self._engine)

    def union(self, other: "DataFrame") -> "DataFrame":
        """This frame's rows, then ``other``'s. Lazy when both share a
        plan; otherwise each side is run once, at first load, through
        its own engine (``DeferredSide``). Schemas (names, dtypes, row
        shapes) must match."""
        if describe_schema(self.schema) != describe_schema(other.schema):
            raise ValueError(
                f"union schema mismatch: {list(self.schema)} vs "
                f"{list(other.schema)}")
        if self._plan == other._plan:
            out = DataFrame(self._sources + other._sources, self._plan,
                            self._engine)
            out._schema = self._schema
            return out

        def deferred(df: "DataFrame") -> List[Source]:
            side = DeferredSide(df._engine, df._plan, df._sources)
            preserving = all(st.row_preserving for st in df._plan)
            return [Source(SideLoad(side, i),
                           s.num_rows if preserving else None)
                    for i, s in enumerate(df._sources)]

        out = DataFrame(deferred(self) + deferred(other),
                        engine=self._engine)
        out._schema = self._schema
        return out

    def join(self, other: "DataFrame", on, how: str = "inner", *,
             broadcast_limit_rows: int = 2_000_000,
             broadcast_limit_bytes: int = 256 << 20) -> "DataFrame":
        """Broadcast hash join: ``other`` (the small side) is collected
        once and probed per batch of this frame. ``on``: a key column or
        a list of them on both sides; ``how``: ``inner`` or ``left``
        (unmatched rows keep None payload). Right keys must be unique
        and non-null; the right side must fit ``broadcast_limit_rows``
        and ``broadcast_limit_bytes``; non-key columns may not exist on
        both sides. The JAX package's rules and messages."""
        keys = [on] if isinstance(on, str) else list(on)
        if not keys:
            raise ValueError("join needs at least one key column")
        if how not in ("inner", "left"):
            raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
        r_batches, n_right, nbytes_right = [], 0, 0
        for rb in other.stream():
            if not num_rows(rb):
                continue
            n_right += num_rows(rb)
            nbytes_right += sum(v.nbytes for v in rb.values())
            if n_right > broadcast_limit_rows:
                raise ValueError(
                    f"broadcast join: right side exceeds "
                    f"broadcast_limit_rows={broadcast_limit_rows:,} "
                    "(the right side materializes in full on every "
                    "process). Swap the sides, pre-aggregate, or pass a "
                    "higher broadcast_limit_rows if it truly fits in "
                    "memory.")
            if nbytes_right > broadcast_limit_bytes:
                raise ValueError(
                    f"broadcast join: right side exceeds "
                    f"broadcast_limit_bytes={broadcast_limit_bytes:,} "
                    f"({nbytes_right:,} bytes so far; the right side "
                    "materializes in full on every process). Swap the "
                    "sides, drop payload columns, or pass a higher "
                    "broadcast_limit_bytes if it truly fits.")
            r_batches.append(rb)
        right = concat_batches(r_batches) if r_batches \
            else dict(other.schema)
        for k in keys:
            column(right, k)          # raise early on a bad key
            column(self.schema, k)
        overlap = (set(self.schema) & set(right)) - set(keys)
        if overlap:
            raise ValueError(
                f"non-key columns {sorted(overlap)} exist on both "
                "sides; rename or drop one side first")
        right_keys = _key_values(right, keys)
        if any(k is None for k in right_keys):
            raise ValueError("right-side join keys contain nulls")
        index = {k: i for i, k in enumerate(right_keys)}
        if len(index) != len(right_keys):
            counts = collections.Counter(right_keys)
            dup = sorted(k for k, c in counts.items() if c > 1)[0]
            raise ValueError(
                f"duplicate join key {dup!r} on the right side; "
                "broadcast join needs unique right keys")
        payload = {k: v for k, v in right.items() if k not in keys}
        return self.map_batches(
            JoinProbe(tuple(keys), how, index, payload),
            name=f"join({','.join(keys)})",
            row_preserving=(how == "left"))

    def sample(self, fraction: float, seed: int = 42) -> "DataFrame":
        """A Bernoulli row sample, the same per (seed, partition) on
        every run; the JAX package's generator, so the same rows."""
        if not (0.0 <= fraction <= 1.0):
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        return self.map_batches(SampleRows(float(fraction), seed),
                                name=f"sample({fraction})",
                                row_preserving=False, with_index=True)

    def show(self, n: int = 20, truncate: int = 40) -> None:
        """Print the first ``n`` rows as a table (Spark ``df.show``),
        each value as the JAX package prints its Python value."""
        from sparkdl_tpu_torch.data.arrow import python_value
        rows = self.take(n)
        cols = self.columns

        def fmt(v):
            text = repr(python_value(v))
            return text if len(text) <= truncate \
                else text[:truncate - 1] + "…"

        widths = {c: len(c) for c in cols}
        rendered = [{c: fmt(r.get(c)) for c in cols} for r in rows]
        for r in rendered:
            for c in cols:
                widths[c] = max(widths[c], len(r[c]))
        line = "+" + "+".join("-" * (widths[c] + 2) for c in cols) + "+"
        print(line)
        print("|" + "|".join(f" {c.ljust(widths[c])} " for c in cols)
              + "|")
        print(line)
        for r in rendered:
            print("|" + "|".join(f" {r[c].ljust(widths[c])} "
                                 for c in cols) + "|")
        print(line)

    def cache(self) -> "DataFrame":
        """Run the plan once and return a frame over the result in
        memory, in as many partitions: later passes (CV folds, epochs)
        re-slice it instead of re-running the plan."""
        return DataFrame.from_columns(self.collect(),
                                      max(1, len(self._sources)),
                                      self._engine)

    _spill_manifest_lock = threading.Lock()

    def cache_to_disk(self, directory: str) -> "DataFrame":
        """A frame whose partitions run this frame's plan once each on
        first load, spill the result to ``directory`` (one ``.npz``, a
        zip of one ``.npy`` a column, written to a temporary name and
        renamed), and are read back from disk afterwards. Object
        columns (strings, image structs) are pickled by numpy: load a
        spill only from a directory this program wrote. Partition
        identity (``logical_index``) is kept, so per-epoch partition
        shuffles compose. Device stages inside the spilled plan run
        inside ``Source.load``, outside the engine's device lock.

        A populated ``directory`` is reused only when its manifest
        matches this frame's shape (schema and partition count); a
        mismatch raises."""
        os.makedirs(directory, exist_ok=True)
        plan = list(self._plan)
        preserving = all(st.row_preserving for st in plan)
        manifest_path = os.path.join(directory, "_manifest.json")
        manifest = {"schema": describe_schema(self.schema),
                    "num_partitions": len(self._sources)}
        with DataFrame._spill_manifest_lock:
            if os.path.exists(manifest_path):
                with open(manifest_path) as f:
                    existing = json.load(f)
                if existing != manifest:
                    raise ValueError(
                        f"cache directory {directory!r} holds a spill "
                        "of a DIFFERENT frame (schema or partition count "
                        "mismatch); use a fresh directory")
            elif [n for n in os.listdir(directory)
                  if not n.startswith("_manifest.json.tmp")]:
                raise ValueError(
                    f"cache directory {directory!r} is not empty and "
                    "has no spill manifest; use a fresh directory")
            else:
                tmp = (f"{manifest_path}.tmp.{os.getpid()}"
                       f".{threading.get_ident()}")
                with open(tmp, "w") as f:
                    json.dump(manifest, f)
                os.replace(tmp, manifest_path)

        def make(i: int, src: Source) -> Source:
            logical = (src.logical_index
                       if src.logical_index is not None else i)
            path = os.path.join(directory, f"part_{logical:05d}.npz")

            def _load(src=src, logical=logical, path=path) -> Batch:
                if os.path.exists(path):
                    return _read_spill(path)
                batch = apply_plan(plan, src.load(), logical)
                # a temporary name per process and thread: a partition
                # re-submitted after an early stop may overlap its first
                # load
                tmp = (f"{path}.tmp.{os.getpid()}"
                       f".{threading.get_ident()}.npz")
                names = list(batch)
                np.savez(tmp, names=np.array(names, dtype=str),
                         **{f"c{j:04d}": batch[n]
                            for j, n in enumerate(names)})
                os.replace(tmp, path)
                return batch

            return Source(_load, src.num_rows if preserving else None,
                          logical_index=src.logical_index,
                          effectful=True)

        out = DataFrame([make(i, s) for i, s in enumerate(self._sources)],
                        engine=self._engine)
        # the spilled frame's load IS the plan: probing it would run and
        # spill a whole partition just to answer a schema question
        out._schema = self.schema
        return out

    def snapshot(self, root: str, fingerprint: str = "",
                 decode_key: Optional[str] = None) -> "DataFrame":
        """A frame backed by the content-addressed snapshot store
        (``inputsvc/snapshot.py``): each partition's first load runs
        this frame's plan and writes a validated chunk under ``root``;
        later loads (the next epoch, another run sharing ``root``) read
        the chunk back. The store key hashes ``fingerprint`` (the
        corpus' identity), ``decode_key`` (the decode configuration; by
        default the plan's stage names) and the format version, so a
        change of any lands in a fresh store. A corrupt, truncated or
        missing chunk is decoded again."""
        from sparkdl_tpu_torch.inputsvc.snapshot import snapshot_sources
        out = DataFrame(
            snapshot_sources(self._sources, list(self._plan), self.schema,
                             root, fingerprint, decode_key),
            engine=self._engine)
        # the snapshot frame's load is the plan: probing it would decode
        # and write a whole partition to answer a schema question
        out._schema = self.schema
        return out

    # -- introspection ------------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return len(self._sources)

    @property
    def schema(self) -> Batch:
        """The frame's zero-row prototype after the plan, computed once
        (stages must accept empty batches). When the first source has a
        ``schema_hint`` (in-memory frames), no partition is loaded;
        otherwise the first partition loads once and is cut to 0
        rows."""
        if self._schema is None:
            if not self._sources:
                return {}
            src = self._sources[0]
            idx = src.logical_index if src.logical_index is not None else 0
            proto = (dict(src.schema_hint) if src.schema_hint is not None
                     else prototype(src.load()))
            self._schema = apply_plan(self._plan, proto, idx)
        return self._schema

    @property
    def schema_probe_free(self) -> bool:
        """Whether reading :attr:`schema` loads no partition: it is
        cached, or the first source has a ``schema_hint``."""
        return (self._schema is not None or not self._sources
                or self._sources[0].schema_hint is not None)

    # -- materialization ----------------------------------------------------

    def stream(self) -> Iterator[Batch]:
        """Ordered iterator of fully transformed partition batches."""
        return self._engine.execute(self._sources, self._plan)

    @property
    def columns(self) -> List[str]:
        """Column names (from :attr:`schema`)."""
        return list(self.schema)

    def collect(self, on_batch=None) -> Batch:
        """The whole frame as one batch. ``on_batch``, when given, is
        called with each streamed batch as it arrives (a byte watchdog's
        seam). Zero-row batches are dropped when others have rows (a
        column computed from no rows may lack its row shape); when all
        are empty, the first is kept as the schema carrier."""
        with span("frame.collect", lane="engine"):
            streamed = StreamedConcat(self.known_count())
            try:
                batches = []
                for b in self.stream():
                    if on_batch is not None:
                        on_batch(b)
                    batches.append(b)
                    streamed.add(b)
                parts = [b for b in batches if num_rows(b)] or batches[:1]
                if not tracer().armed:
                    return _concat_pass(parts, streamed)
                nbytes = sum(int(getattr(v, "nbytes", 0))
                             for b in parts for v in b.values())
                with span("frame.concat", lane="engine",
                          rows=sum(num_rows(b) for b in parts),
                          bytes=nbytes, streamed=streamed.streaming,
                          tail_bytes=streamed.tail_bytes(parts)):
                    return _concat_pass(parts, streamed)
            finally:
                streamed.close()

    def collect_rows(self) -> List[dict]:
        batch = self.collect()
        return [{k: v[i] for k, v in batch.items()}
                for i in range(num_rows(batch))]

    def take(self, n: int) -> List[dict]:
        """The first ``n`` rows; the stream stops as soon as they are
        in (the engine cancels or drains what is still in flight)."""
        out: List[dict] = []
        stream = self.stream()
        try:
            for b in stream:
                out += [{k: v[i] for k, v in b.items()}
                        for i in range(num_rows(b))]
                if len(out) >= n:
                    break
        finally:
            close = getattr(stream, "close", None)
            if close is not None:
                close()
        return out[:n]

    def first(self) -> Optional[dict]:
        """The first row, or None for an empty frame."""
        rows = self.take(1)
        return rows[0] if rows else None

    def to_pandas(self):
        """The whole frame as a pandas ``DataFrame``, through the JAX
        package's Arrow layout (``data/arrow.py``)."""
        from sparkdl_tpu_torch.data import arrow
        return arrow.batch_to_pandas(self.collect())

    def count(self) -> int:
        known = self.known_count()
        if known is not None:
            return known
        return sum(num_rows(b) for b in self.stream())

    def known_count(self) -> Optional[int]:
        """The row count without running the plan, or None when that
        would need it (a stage that drops rows, or sources without
        counts)."""
        if all(st.row_preserving for st in self._plan) and \
                all(s.num_rows is not None for s in self._sources):
            return sum(s.num_rows for s in self._sources)
        return None

    def tensor(self, col: str) -> np.ndarray:
        """One tensor column as a stacked ndarray [N, *shape]."""
        return column_to_tensor(column(self.collect(), col))

    def __repr__(self) -> str:
        return (f"DataFrame({len(self._sources)} partitions, "
                f"{len(self._plan)} stages)")


def describe_schema(schema: Batch) -> list:
    """``[name, dtype, row shape]`` of each column of a prototype."""
    return [[k, v.dtype.str, list(v.shape[1:])] for k, v in schema.items()]


def _read_spill(path: str) -> Batch:
    with np.load(path, allow_pickle=True) as z:
        names = [str(n) for n in z["names"]]
        return {n: z[f"c{j:04d}"] for j, n in enumerate(names)}
