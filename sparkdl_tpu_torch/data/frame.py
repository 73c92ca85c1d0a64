"""Immutable partitioned frame over numpy batches — counterpart of
``sparkdl_tpu/data/frame.py`` for the operations the port's pipelines
use.

A partition is a :class:`Source` that loads one batch (an ordered dict
of column → ndarray); a frame is its sources plus a plan of
batch → batch stages, run lazily by its engine
(``data/engine.py::LocalEngine``, the default engine unless the frame
was given one) when the frame is collected. There is no pyarrow: strings
and image structs are object arrays, tensor columns are ``[N, *shape]``
arrays. A frame's "schema" is a zero-row prototype batch: the column
names in order, each an empty array of the column's dtype and row shape.

The sources and stages the frame builds itself are module-level
callables (small frozen dataclasses with ``__call__``), not closures, so
a plan ships to the host pipeline's worker processes and to a decode
fleet with the standard library's ``pickle``; a user's own lambda
in ``map_batches`` stays as given, and the pipeline then takes its
counted thread fallback.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.data.tensors import Batch, column_to_tensor


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
    return {k: np.concatenate([b[k] for b in batches])
            for k in batches[0]}


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
        batches = []
        for b in self.stream():
            if on_batch is not None:
                on_batch(b)
            batches.append(b)
        non_empty = [b for b in batches if num_rows(b)]
        return concat_batches(non_empty or batches[:1])

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
