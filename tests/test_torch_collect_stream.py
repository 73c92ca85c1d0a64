"""The port's streaming collect (``data/collect.py``) against the
concatenation it replaces: ``DataFrame.collect`` of a pass that streams
returns what ``concat_batches`` of its kept batches returns (keys in
order, dtypes, array classes, bytes), over numeric and fixed-width
columns, ``TensorColumn`` pieces, empty partitions, pieces that fall
back, frames that do not stream, object columns and a re-chunked device
stage; errors propagate and leave no helper thread; the copies run off
the consumer thread; the registry counts one route a pass."""

import sys
import threading
import time

import numpy as np
import pytest

from sparkdl_tpu_torch.data import collect as collect_mod
from sparkdl_tpu_torch.data.frame import (
    ConstantLoad,
    DataFrame,
    Source,
    concat_batches,
    num_rows,
    prototype,
)
from sparkdl_tpu_torch.data.tensors import TensorColumn
from sparkdl_tpu_torch.obs import default_registry

ROUTES = ("frame.collect.streamed", "frame.collect.concatenated",
          "frame.collect.fallback_columns")


@pytest.fixture
def small_stream(monkeypatch):
    """Stream passes of any size, in slabs of a few rows, so tiny frames
    take the streamed route and split their last copy."""
    monkeypatch.setattr(collect_mod, "STREAM_MIN_BYTES", 1)
    monkeypatch.setattr(collect_mod, "SLAB_MIN_BYTES", 64)


def _counts():
    reg = default_registry()
    return {k: reg.counter(k).value for k in ROUTES}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _helpers():
    return [t for t in threading.enumerate()
            if t.name.startswith("frame.collect")]


@pytest.fixture
def pools(monkeypatch):
    """The helper pools collect starts, recorded as they start."""
    started = []
    real = collect_mod.ThreadPoolExecutor

    def recording(*args, **kwargs):
        started.append(real(*args, **kwargs))
        return started[-1]

    monkeypatch.setattr(collect_mod, "ThreadPoolExecutor", recording)
    return started


def _sources(parts):
    """One source a batch, each with its row count and the first
    batch's zero-row prototype as schema hint."""
    hint = prototype(parts[0])
    return [Source(ConstantLoad(p), num_rows(p), schema_hint=hint)
            for p in parts]


def _numeric(rng, n=40):
    return {"u8": rng.integers(0, 255, n, dtype=np.uint8),
            "f1": rng.standard_normal((n, 5)).astype(np.float32),
            "f2": rng.standard_normal((n, 2, 3)).astype(np.float32),
            "u3": rng.integers(0, 255, (n, 2, 3, 4), dtype=np.uint8)}


def _numeric_frame(rng):
    return DataFrame.from_columns(_numeric(rng), num_partitions=4)


def _tensor_column_frame(rng):
    return _numeric_frame(rng).with_column(
        "t", lambda b: b["u8"].astype(np.float32) * 0.5)


def _zero_row_partition_frame(rng):
    cols = _numeric(rng, 30)
    parts = [{k: v[lo:hi] for k, v in cols.items()}
             for lo, hi in ((0, 12), (12, 12), (12, 30))]
    return DataFrame(_sources(parts))


def _all_empty_frame(rng):
    cols = _numeric(rng, 0)
    return DataFrame(_sources([cols, cols]))


class _MixedWidth:
    """A stage whose column is float32 on every partition but the one
    of 11 rows, where it is float64: the zero-row schema says float32."""

    def __call__(self, batch):
        n = num_rows(batch)
        out = batch["f1"][:, 0].astype(np.float64 if n == 11 else
                                       np.float32)
        return {**batch, "m": out}


class _SometimesTensorColumn:
    """A stage whose 1-D column is a ``TensorColumn`` on every partition
    but the first."""

    def __call__(self, batch, index):
        col = batch["f1"][:, 1].copy()
        return {**batch, "s": col if index == 0 else col.view(TensorColumn)}


def _mixed_tensor_column_frame(rng):
    return _numeric_frame(rng).map_batches(_SometimesTensorColumn(),
                                           with_index=True)


def _dtype_mismatch_frame(rng):
    cols = _numeric(rng, 33)
    parts = [{k: v[lo:hi] for k, v in cols.items()}
             for lo, hi in ((0, 9), (9, 20), (20, 33))]
    return DataFrame(_sources(parts)).map_batches(_MixedWidth())


def _rows_differ_frame(rng):
    """A source whose count says one row more than its load gives."""
    cols = _numeric(rng, 20)
    hint = prototype(cols)
    parts = [{k: v[:10] for k, v in cols.items()},
             {k: v[10:] for k, v in cols.items()}]
    return DataFrame([Source(ConstantLoad(parts[0]), 10, schema_hint=hint),
                      Source(ConstantLoad(parts[1]), 11, schema_hint=hint)])


def _filtered_frame(rng):
    return _numeric_frame(rng).filter(lambda b: b["u8"] % 2 == 0)


def _object_frame(rng):
    cols = _numeric(rng, 24)
    names = np.empty(24, dtype=object)
    names[:] = [f"row-{i}" for i in range(24)]
    return DataFrame.from_columns({"name": names, **cols},
                                  num_partitions=3)


class _StandIn:
    """A device stage's stand-in: appends the rows' sum, a float32
    [N, 3] column, and records each call's rows."""

    def __init__(self):
        self.calls = []

    def __call__(self, batch):
        n = num_rows(batch)
        self.calls.append(n)
        s = batch["f1"].sum(axis=1, dtype=np.float32)
        return {**batch, "dev": np.stack([s, s + 1, s * 2], axis=1)}


def _rechunk_frame(rng):
    cols = _numeric(rng, 37)
    bounds = (0, 5, 13, 13, 30, 37)
    parts = [{k: v[lo:hi] for k, v in cols.items()}
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    return DataFrame(_sources(parts)).map_batches(
        _StandIn(), kind="device", name="stand_in", batch_hint=8)


#: (frame, the route it takes, streamed columns that fall back)
CASES = {
    "numeric_1d_to_3d_rows": (_numeric_frame, "streamed", 0),
    "tensor_column": (_tensor_column_frame, "streamed", 0),
    "mixed_tensor_column": (_mixed_tensor_column_frame, "streamed", 0),
    "zero_row_partition": (_zero_row_partition_frame, "streamed", 0),
    "all_empty": (_all_empty_frame, "concatenated", 0),
    "dtype_mismatch": (_dtype_mismatch_frame, "streamed", 1),
    "rows_differ": (_rows_differ_frame, "streamed", 4),
    "filtered": (_filtered_frame, "concatenated", 0),
    "object_column": (_object_frame, "streamed", 0),
    "rechunk_device_stage": (_rechunk_frame, "streamed", 0),
}


def _expected(df):
    batches = list(df.stream())
    parts = [b for b in batches if num_rows(b)] or batches[:1]
    return concat_batches(parts)


def _assert_same(got, want):
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert type(g) is type(w), k
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype == object:
            assert g.tolist() == w.tolist(), k
        else:
            assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("case", list(CASES))
def test_collect_equals_concat_batches(case, small_stream):
    build, route, fallback = CASES[case]
    df = build(np.random.default_rng(7))
    want = _expected(df)
    before = _counts()
    got = df.collect()
    _assert_same(got, want)
    assert _delta(before) == {
        "frame.collect.streamed": float(route == "streamed"),
        "frame.collect.concatenated": float(route == "concatenated"),
        "frame.collect.fallback_columns": float(fallback)}
    assert not _helpers()


def test_tensor_column_kept_only_when_every_piece_is_one(small_stream):
    df = _tensor_column_frame(np.random.default_rng(1))
    out = df.collect()
    assert type(out["t"]) is TensorColumn
    assert type(out["f1"]) is np.ndarray


def test_rechunked_stage_sees_hint_blocks(small_stream):
    df = _rechunk_frame(np.random.default_rng(2))
    stage = df._plan[-1].fn
    df.collect()
    # blocks cut at the hint across the partitions (5, 8, 0, 17, 7
    # rows), the empty one run as it is; no zero-row call reads a schema
    assert stage.calls == [8, 0, 16, 8, 5]


class _FailOn:
    def __init__(self, rows):
        self.rows = rows

    def __call__(self, batch):
        if num_rows(batch) == self.rows:
            raise ValueError("planted failure")
        return batch


def test_error_mid_stream_propagates_and_leaves_no_helper(small_stream,
                                                          pools):
    cols = _numeric(np.random.default_rng(3), 30)
    parts = [{k: v[lo:hi] for k, v in cols.items()}
             for lo, hi in ((0, 10), (10, 17), (17, 30))]
    df = DataFrame(_sources(parts)).map_batches(_FailOn(7))
    with pytest.raises(ValueError, match="planted failure"):
        df.collect()
    # the pass streamed its first batch before the failure
    assert len(pools) == 1
    assert not _helpers()


def test_copies_run_off_the_consumer_thread(small_stream, monkeypatch):
    seen = []
    copy = collect_mod.StreamedConcat._copy

    def recording(self, *args):
        seen.append(threading.current_thread().name)
        return copy(self, *args)

    monkeypatch.setattr(collect_mod.StreamedConcat, "_copy", recording)
    df = _numeric_frame(np.random.default_rng(4))
    _assert_same(df.collect(), _expected(df))
    # one copy for each of the first 3 partitions, the last one's split
    # in slabs over the helpers
    assert len(seen) == 3 + collect_mod.COPY_THREADS
    assert threading.current_thread().name not in seen
    assert all(name.startswith("frame.collect") for name in seen)


def test_on_batch_sees_every_batch_in_order(small_stream):
    df = _zero_row_partition_frame(np.random.default_rng(5))
    seen = []
    df.collect(on_batch=seen.append)
    want = list(df.stream())
    assert [num_rows(b) for b in seen] == [12, 0, 18]
    for got, exp in zip(seen, want):
        assert all(np.array_equal(got[k], exp[k]) for k in exp)


def test_counters_count_one_route_a_pass(small_stream):
    df = _numeric_frame(np.random.default_rng(6))
    before = _counts()
    for _ in range(3):
        df.collect()
    assert _delta(before)["frame.collect.streamed"] == 3
    assert _delta(before)["frame.collect.concatenated"] == 0


def test_small_pass_concatenates_without_helpers(pools):
    """At the module's own threshold a frame of a few KB takes the end
    concatenation: no helper thread starts."""
    df = _numeric_frame(np.random.default_rng(8))
    before = _counts()
    _assert_same(df.collect(), _expected(df))
    assert _delta(before)["frame.collect.concatenated"] == 1
    assert not pools


def test_pass_above_threshold_streams_at_module_defaults(pools):
    """A 6-MB frame of uint8 rows streams with the module's constants,
    its last copy in slabs of at least a MB."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 255, (96, 64 * 1024), dtype=np.uint8)
    df = DataFrame.from_columns({"x": x}, num_partitions=3)
    before = _counts()
    out = df.collect()
    assert out["x"].tobytes() == x.tobytes()
    assert _delta(before)["frame.collect.streamed"] == 1
    assert len(pools) == 1
    assert pools[0]._max_workers == collect_mod.COPY_THREADS


def test_stress_many_partitions_fast_switching(small_stream):
    """Many partitions of uneven sizes with the interpreter switching
    threads every microsecond: every row lands in its place."""
    rng = np.random.default_rng(10)
    sizes = rng.integers(0, 9, 64)
    cols = _numeric(rng, int(sizes.sum()))
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    parts = [{k: v[lo:hi] for k, v in cols.items()}
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    df = DataFrame(_sources(parts))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        for _ in range(5):
            _assert_same(df.collect(), concat_batches(
                [p for p in parts if num_rows(p)]))
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert not _helpers()
