"""The port's parallel host pipeline (``sparkdl_tpu_torch/data/pipeline.py``)
against the JAX package's on the CPU: the same seeded numpy partitions
through JAX's ``LocalEngine(pipeline_workers=N, pipeline_mode=...)`` and
the port's, in thread and process mode. Rows, their order and their bytes
are compared exactly; model outputs within ``TOL_FEATURES`` of the
largest. Also the resolvers case for case, the failure semantics, the
thread fallback, the shared-memory discipline and the numpy batch codec.

The process-mode engines are module-scoped: each spawned port worker
imports the port (and this module, for its stages), which takes about a
second. The JAX process engines fork, as the JAX package's own tests do.
This module imports neither JAX nor torch at its top, so a spawned
worker that imports it for a stage loads neither. Counters are
process-wide and other test files share the process: every check reads
a difference of two snapshots."""

import dataclasses
import glob
import os
import pickle
import signal
import threading
import time

import numpy as np
import pytest

# TestNet in float32 on both sides over the same 32×32 pixels (the
# model's own size, so nothing is resized): features differ by the
# order of float32 sums, 1e-5 of their largest magnitude (as
# tests/test_torch_slice.py)
TOL_FEATURES = 1e-5
HINT = 16
LAYOUTS = {
    "zero_row": (0, 5, 0),
    "single_row": (1,),
    "seventeen": (17,),
    "uneven12": (3, 0, 7, 1, 12, 5, 9, 2, 0, 4, 8, 6),
    "one_200": (200,),
    "sixty_fours": (64, 64, 64),
}
# a bound on every wait in this module: a hung pool fails one test
WAIT_S = 60.0


#: every test here ends within this: a hung pool, worker or server fails
#: its test (SIGALRM interrupts the wait) instead of stalling the run
TEST_LIMIT_S = 120


@pytest.fixture(autouse=True)
def _bounded():
    def fail(signum, frame):
        raise TimeoutError(f"test ran past {TEST_LIMIT_S} s")

    old = signal.signal(signal.SIGALRM, fail)
    signal.alarm(TEST_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


# -- stages the port ships to its workers (module level, so they pickle) --

def _port_affine(batch):
    return {**batch, "y": batch["x"] * np.float32(2) + np.float32(1)}


def _port_keep(batch):
    return batch["id"] % 5 != 0


def _port_ident(batch):
    return batch


def _port_boom(batch):
    raise ValueError("decode exploded on purpose")


def _port_slow(batch, idx):
    # later partitions finish first
    time.sleep(0.03 * (8 - idx) / 8)
    return batch


def _probe_worker(batch):
    """What the worker process holds: its pid and loaded modules."""
    import sys
    n = len(batch["id"])
    mods = np.empty(n, dtype=object)
    mods[:] = [sorted(sys.modules)] * n
    return {**batch, "pid": np.full(n, os.getpid()), "mods": mods}


@dataclasses.dataclass(frozen=True)
class FailOnce:
    """Raises ``exc_type`` on the first attempt of each partition in
    ``fail``, through a marker file (the file system is the only state
    pool workers share)."""
    marker_dir: str
    fail: frozenset
    exc_type: type

    def __call__(self, batch, idx):
        marker = os.path.join(self.marker_dir, f"failed_{idx}")
        if idx in self.fail and not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("failed")
            raise self.exc_type(f"transient decode hiccup at {idx}")
        return batch


# -- frames --------------------------------------------------------------

def _parts(sizes, seed=0):
    rng = np.random.default_rng(seed)
    out, start = [], 0
    for n in sizes:
        out.append({"id": np.arange(start, start + n, dtype=np.int64),
                    "x": rng.normal(size=n).astype(np.float32),
                    "tag": np.array([f"r{start + i}" for i in range(n)],
                                    dtype=object)})
        start += n
    return out


def _port_df(parts, engine):
    from sparkdl_tpu_torch.data.frame import ConstantLoad, DataFrame, Source
    return DataFrame([Source(ConstantLoad(p), len(p["id"])) for p in parts],
                     engine=engine)


def _jax_df(parts, engine):
    import pyarrow as pa
    from sparkdl_tpu.data.frame import DataFrame
    return DataFrame.from_batches(
        [pa.RecordBatch.from_pydict({
            "id": pa.array(p["id"], pa.int64()),
            "x": pa.array(p["x"], pa.float32()),
            "tag": pa.array(list(p["tag"]), pa.string())})
         for p in parts], engine=engine)


def _jax_affine(batch):
    import pyarrow as pa
    x = batch.column(batch.schema.get_field_index("x")).to_numpy()
    return batch.append_column(
        "y", pa.array(x * np.float32(2) + np.float32(1), pa.float32()))


def _jax_keep(batch):
    import pyarrow as pa
    ids = batch.column(batch.schema.get_field_index("id")).to_numpy()
    return batch.filter(pa.array(ids % 5 != 0))


def _jax_cols(batches):
    """JAX record batches → [{name: ndarray}] per partition."""
    return [{name: b.column(i).to_numpy(zero_copy_only=False)
             for i, name in enumerate(b.schema.names)} for b in batches]


def _delta(reg, before, name):
    return reg.snapshot().get(name, 0.0) - before.get(name, 0.0)


@pytest.fixture(scope="module")
def port_process():
    from sparkdl_tpu_torch.data.engine import LocalEngine
    eng = LocalEngine(pipeline_workers=2, pipeline_mode="process")
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def jax_process():
    from sparkdl_tpu.data.engine import LocalEngine
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPARKDL_TPU_PIPELINE_MPCTX", "fork")
        eng = LocalEngine(pipeline_workers=2, pipeline_mode="process")
        yield eng
        eng.shutdown()


@pytest.fixture
def engines(request, port_process, jax_process):
    """(port engine, JAX engine) in the mode the test is parametrised
    with; thread engines are made per test."""
    mode = request.param
    if mode == "process":
        yield port_process, jax_process
        return
    from sparkdl_tpu.data.engine import LocalEngine as JaxEngine
    from sparkdl_tpu_torch.data.engine import LocalEngine
    port = LocalEngine(pipeline_workers=3, pipeline_mode="thread")
    ref = JaxEngine(pipeline_workers=3, pipeline_mode="thread")
    yield port, ref
    port.shutdown()
    ref.shutdown()


MODES = pytest.mark.parametrize("engines", ["thread", "process"],
                                indirect=True)


@MODES
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pooled_prefix_matches_jax(engines, layout):
    """A host prefix (a stage that appends a column, a filter) on the
    pool, then a device stage with a batch hint of 16 on the consumer:
    the same partitions, rows, order and bytes as the JAX package's
    pooled engine, and the same device-stage calls."""
    from sparkdl_tpu_torch.obs import default_registry
    port, ref = engines
    parts = _parts(LAYOUTS[layout])
    calls, ref_calls = [], []

    def dev(batch):
        calls.append(len(batch["id"]))
        return batch

    def jax_dev(batch):
        ref_calls.append(batch.num_rows)
        return batch

    reg = default_registry()
    before = reg.snapshot()
    got = list(_port_df(parts, port).map_batches(_port_affine, name="affine")
               .filter(_port_keep)
               .map_batches(dev, kind="device", name="dev", batch_hint=HINT)
               .stream())
    want = _jax_cols(_jax_df(parts, ref).map_batches(_jax_affine)
                     .map_batches(_jax_keep, row_preserving=False)
                     .map_batches(jax_dev, kind="device", name="dev",
                                  batch_hint=HINT).stream())
    assert calls == ref_calls
    assert len(got) == len(want) == len(parts)
    for b, r in zip(got, want):
        assert list(b) == list(r) == ["id", "x", "tag", "y"]
        for name in ("id", "x", "y"):
            assert b[name].dtype == r[name].dtype
            assert b[name].tobytes() == r[name].tobytes()
        assert list(b["tag"]) == list(r["tag"])
    assert _delta(reg, before, "pipeline.fallbacks") == 0
    assert _delta(reg, before, "pipeline.tasks") == len(parts)
    if port.pipeline_mode == "process":
        assert _delta(reg, before, "pipeline.handoff_bytes") > 0


@MODES
def test_out_of_order_completion_stays_ordered(engines):
    port, _ = engines
    ids = np.arange(90)
    out = _port_df(_parts([10] * 9), port).map_batches(
        _port_slow, with_index=True, name="slow").collect()
    np.testing.assert_array_equal(out["id"], ids)


@MODES
def test_with_index_sees_logical_identity(engines):
    """Reordered partitions keep their logical index through the pool,
    as in the JAX package."""
    port, ref = engines
    parts = _parts([10, 10, 10, 10])
    order = [3, 1, 2, 0]
    got = _port_df(parts, port).with_partition_order(order) \
        .map_batches(_probe_index, with_index=True).collect()
    want = _jax_cols([_jax_df(parts, ref).with_partition_order(order)
                      .map_batches(_jax_probe_index, with_index=True)
                      .collect().combine_chunks().to_batches()[0]])[0]
    np.testing.assert_array_equal(got["id"], want["id"])
    np.testing.assert_array_equal(got["part"], want["part"])
    np.testing.assert_array_equal(got["part"], np.repeat(order, 10))


def _probe_index(batch, idx):
    return {**batch, "part": np.full(len(batch["id"]), idx, np.int64)}


def _jax_probe_index(batch, idx):
    import pyarrow as pa
    return batch.append_column(
        "part", pa.array(np.full(batch.num_rows, idx, np.int64)))


@MODES
def test_empty_partitions_keep_schema(engines):
    port, _ = engines
    parts = _parts([0, 0, 3, 0])
    got = list(_port_df(parts, port).map_batches(_port_affine).stream())
    assert [len(b["id"]) for b in got] == [0, 0, 3, 0]
    for b in got:
        assert list(b) == ["id", "x", "tag", "y"]
        assert (b["id"].dtype, b["y"].dtype) == (np.int64, np.float32)


class _Chunky:
    """A ``LiveBatchHint`` runner stand-in whose device batch moves."""

    def __init__(self, n):
        self.batch_size = n

    @property
    def preferred_chunk(self):
        return self.batch_size


@MODES
def test_mid_stream_hint_change(engines):
    """A LiveBatchHint shrink then regrow while pooled fragments are in
    flight: rows exact, and the cuts follow the moved hint as the JAX
    engine's do."""
    from sparkdl_tpu.data.frame import LiveBatchHint as JaxHint
    from sparkdl_tpu_torch.data.frame import LiveBatchHint
    port, ref = engines
    parts = _parts([8] * 8)

    def run(df_fn, hint_cls, rows_of):
        chunky, seen = _Chunky(8), []

        def dev(batch):
            seen.append(rows_of(batch))
            if len(seen) == 1:
                chunky.batch_size = 4
            elif len(seen) == 3:
                chunky.batch_size = 12
            return batch

        out = df_fn().map_batches(dev, kind="device", name="dev",
                                  batch_hint=hint_cls(chunky)).collect()
        return out, seen

    got, seen = run(lambda: _port_df(parts, port).map_batches(_port_ident),
                    LiveBatchHint, lambda b: len(b["id"]))
    want, ref_seen = run(
        lambda: _jax_df(parts, ref).map_batches(lambda b: b), JaxHint,
        lambda b: b.num_rows)
    np.testing.assert_array_equal(got["id"], np.arange(64))
    assert seen == ref_seen
    assert seen[0] == 8 and sum(seen) == 64


def test_typed_error_surfaces_once_in_thread_mode():
    from sparkdl_tpu_torch.data.engine import LocalEngine
    eng = LocalEngine(pipeline_workers=3, pipeline_mode="thread")
    calls = []

    def boom(batch, idx):
        calls.append(idx)
        if idx == 2:
            raise KeyError("bad column xyz")
        return batch

    try:
        with pytest.raises(KeyError, match="bad column xyz"):
            _port_df(_parts([10] * 4), eng).map_batches(
                boom, with_index=True).collect()
        assert calls.count(2) == 1   # a KeyError is not retried
        out = _port_df(_parts([10] * 4), eng).map_batches(
            _port_ident).collect()
        np.testing.assert_array_equal(out["id"], np.arange(40))
    finally:
        eng.shutdown()


def test_typed_error_crosses_the_process_wire(port_process):
    """The worker's ValueError reaches the consumer as itself, and the
    engine runs the next stream on the same pool."""
    from sparkdl_tpu_torch.obs import default_registry
    reg = default_registry()
    before = reg.snapshot()
    with pytest.raises(ValueError, match="decode exploded"):
        _port_df(_parts([5] * 4), port_process).map_batches(
            _port_boom).collect()
    out = _port_df(_parts([5] * 4), port_process).map_batches(
        _port_ident).collect()
    np.testing.assert_array_equal(out["id"], np.arange(20))
    assert _delta(reg, before, "pipeline.fallbacks") == 0


def test_effectful_plan_drains_stragglers():
    """An effectful plan's in-flight siblings finish before control
    returns after an error."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    eng = LocalEngine(pipeline_workers=3, pipeline_mode="thread")
    done = []
    started = threading.Semaphore(0)
    release = threading.Event()

    def effectful(batch, idx):
        if idx == 0:
            started.acquire(timeout=5.0)
            started.acquire(timeout=5.0)
            raise ValueError("primary failure")
        started.release()
        release.wait(5.0)
        done.append(idx)
        return batch

    df = _port_df(_parts([10] * 3), eng).map_batches(
        effectful, with_index=True, effectful=True)
    errors = []

    def run():
        try:
            df.collect()
        except ValueError as e:
            errors.append(e)

    t = threading.Thread(target=run)
    try:
        t.start()
        time.sleep(0.1)
        release.set()
        t.join(WAIT_S)
        assert not t.is_alive()
        assert len(errors) == 1
        assert sorted(done) == [1, 2]
    finally:
        release.set()
        eng.shutdown()


def test_handoff_error_is_typed_transient():
    from sparkdl_tpu.data import pipeline as jax_pipeline
    from sparkdl_tpu_torch.data import pipeline
    from sparkdl_tpu_torch.resilience.errors import TransientError, is_transient
    assert issubclass(pipeline.PipelineHandoffError, TransientError)
    assert is_transient(pipeline.PipelineHandoffError("gone"))
    assert issubclass(jax_pipeline.PipelineHandoffError,
                      jax_pipeline.TransientError)
    # a segment that vanished before the consumer read it
    with pytest.raises(pipeline.PipelineHandoffError):
        pipeline._consume_result(("shm", "psm_sparkdl_gone", 8, 0.0, [], 1))


def test_transient_worker_failure_retries_parent_side(tmp_path,
                                                      port_process,
                                                      jax_process):
    """Seeded partitions fail once, transiently, inside a pool worker:
    the consumer re-runs each through the engine's shared retry policy,
    every row lands once, and the retry counts equal the JAX engine's."""
    from sparkdl_tpu.obs import default_registry as jax_registry
    from sparkdl_tpu.resilience.errors import TransientError as JaxTransient
    from sparkdl_tpu_torch.obs import default_registry
    from sparkdl_tpu_torch.resilience.errors import TransientError
    rng = np.random.default_rng(11)
    fail = frozenset(int(i) for i in rng.choice(6, size=3, replace=False))
    parts = _parts([7] * 6)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    reg, jreg = default_registry(), jax_registry()
    before, jbefore = reg.snapshot(), jreg.snapshot()
    port_retries = port_process.retries
    out = _port_df(parts, port_process).map_batches(
        FailOnce(str(tmp_path / "port"), fail, TransientError),
        with_index=True).collect()
    ref = _jax_df(parts, jax_process).map_batches(
        FailOnce(str(tmp_path / "jax"), fail, JaxTransient),
        with_index=True).collect()
    np.testing.assert_array_equal(out["id"], np.arange(42))
    np.testing.assert_array_equal(
        ref.column("id").to_numpy(), np.arange(42))
    retries = _delta(reg, before, "engine.retries")
    assert retries == _delta(jreg, jbefore, "engine.retries") == len(fail)
    assert port_process.retries - port_retries == len(fail)


@pytest.mark.parametrize("workers_env", ["", "4", "banana", "-3", "0"])
@pytest.mark.parametrize("read_ahead_env", ["", "5", "0", "x"])
def test_resolvers_match_jax(monkeypatch, workers_env, read_ahead_env):
    from sparkdl_tpu.data import pipeline as jax_pipeline
    from sparkdl_tpu.obs import default_registry as jax_registry
    from sparkdl_tpu_torch.data import pipeline
    from sparkdl_tpu_torch.obs import default_registry
    for mod in (jax_pipeline, pipeline):
        monkeypatch.setenv(mod.ENV_WORKERS, workers_env)
        monkeypatch.setenv(mod.ENV_READ_AHEAD, read_ahead_env)
    reg, jreg = default_registry(), jax_registry()
    before, jbefore = reg.snapshot(), jreg.snapshot()
    for explicit in (None, 3, -1):
        got = pipeline.resolve_workers(explicit)
        assert got == jax_pipeline.resolve_workers(explicit)
        for ra in (None, 0, 7):
            assert pipeline.resolve_read_ahead(ra, got) == \
                jax_pipeline.resolve_read_ahead(ra, got)
    assert _delta(reg, before, "pipeline.config_errors") == \
        _delta(jreg, jbefore, "pipeline.config_errors")


@pytest.mark.parametrize("mode_env", ["", "thread", "PROCESS", "bogus"])
def test_mode_resolver_matches_jax(monkeypatch, mode_env):
    from sparkdl_tpu.data import pipeline as jax_pipeline
    from sparkdl_tpu_torch.data import pipeline
    monkeypatch.setenv(jax_pipeline.ENV_MODE, mode_env)
    monkeypatch.setenv(pipeline.ENV_MODE, mode_env)
    for explicit in (None, "thread", "Auto", "nope"):
        assert pipeline.resolve_mode(explicit) == \
            jax_pipeline.resolve_mode(explicit)


@pytest.mark.parametrize("cores", [1, 8])
def test_effective_workers_matches_jax(monkeypatch, cores):
    """Including the 1-core auto degrade, counted the same way."""
    from sparkdl_tpu.data import pipeline as jax_pipeline
    from sparkdl_tpu.obs import default_registry as jax_registry
    from sparkdl_tpu_torch.data import pipeline
    from sparkdl_tpu_torch.obs import default_registry
    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    reg, jreg = default_registry(), jax_registry()
    before, jbefore = reg.snapshot(), jreg.snapshot()
    for req in (0, 1, 2, 5):
        for mode in ("auto", "process", "thread"):
            for record in (True, False):
                assert pipeline.effective_workers(req, mode, record) == \
                    jax_pipeline.effective_workers(req, mode, record)
    assert _delta(reg, before, "pipeline.degrade_events") == \
        _delta(jreg, jbefore, "pipeline.degrade_events") == \
        (2 if cores == 1 else 0)


def test_fork_is_never_picked_once_cuda_is_up(monkeypatch):
    """With CUDA initialised a worker cannot fork; spawn where the main
    module allows it, else no process pool (the thread fallback)."""
    import torch
    from sparkdl_tpu_torch.data import pipeline
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setenv(pipeline.ENV_MPCTX, "fork")
    monkeypatch.setattr(pipeline, "_spawn_safe", lambda: True)
    assert pipeline._mp_context().get_start_method() == "spawn"
    monkeypatch.setattr(pipeline, "_spawn_safe", lambda: False)
    assert pipeline._mp_context() is None
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert pipeline._mp_context().get_start_method() == "fork"


def test_lambda_plan_falls_back_to_threads(port_process):
    from sparkdl_tpu_torch.obs import default_registry
    reg = default_registry()
    before = reg.snapshot()
    out = _port_df(_parts([6] * 3), port_process).map_batches(
        lambda b: b).collect()
    np.testing.assert_array_equal(out["id"], np.arange(18))
    assert _delta(reg, before, "pipeline.fallbacks") == 1


def _segments():
    return set(glob.glob("/dev/shm/psm_*"))


def test_take_abandons_a_process_stream_without_leaking_segments(
        port_process):
    """take(1) abandons in-flight fragments; every segment they made is
    unlinked once they land."""
    from sparkdl_tpu_torch.obs import default_registry
    hp = port_process._host_pipeline()
    hp.shm_min_bytes = 0
    reg = default_registry()
    before_segments = _segments()
    before = reg.snapshot()
    try:
        rows = _port_df(_parts([10] * 8), port_process).map_batches(
            _port_slow, with_index=True).take(1)
        assert rows[0]["id"] == 0
        deadline = time.perf_counter() + WAIT_S
        while time.perf_counter() < deadline and \
                (reg.gauge("pipeline.inflight").value
                 or _segments() - before_segments):
            time.sleep(0.05)
        assert not _segments() - before_segments
        assert reg.gauge("pipeline.inflight").value == 0
        assert _delta(reg, before, "pipeline.shm_segments") >= 1
    finally:
        hp.shm_min_bytes = 64 * 1024


def test_small_fragments_ride_the_pipe(port_process):
    from sparkdl_tpu_torch.obs import default_registry
    reg = default_registry()
    before = reg.snapshot()
    out = _port_df(_parts([10] * 3), port_process).map_batches(
        _port_ident).collect()
    np.testing.assert_array_equal(out["id"], np.arange(30))
    assert _delta(reg, before, "pipeline.shm_segments") == 0
    assert _delta(reg, before, "pipeline.handoff_bytes") > 0


def test_worker_process_stays_off_jax_and_cuda(port_process):
    """A spawned worker loads none of jax, flax, sparkdl_tpu, pyarrow,
    PIL, msgpack or cloudpickle, and has not initialised CUDA."""
    out = _port_df(_parts([4] * 2), port_process).map_batches(
        _probe_worker).collect()
    assert set(out["pid"]) and os.getpid() not in set(out["pid"])
    banned = ("jax", "flax", "sparkdl_tpu", "pyarrow", "PIL", "msgpack",
              "cloudpickle")
    for mods in out["mods"]:
        assert [m for m in mods if m.split(".")[0] in banned] == []
    assert "sparkdl_tpu_torch.data.pipeline" in out["mods"][0]


def test_broken_pool_raises_typed_and_later_streams_use_threads(
        monkeypatch):
    """A worker that dies (the env-armed worker-death drill) breaks the
    pool: the stream raises PipelineWorkerError, the fallback is counted,
    and the next stream runs on threads."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    from sparkdl_tpu_torch.data.pipeline import PipelineWorkerError
    from sparkdl_tpu_torch.obs import default_registry
    monkeypatch.setenv("SPARKDL_TPU_FAULTS",
                       "pipeline.worker_death:transient:1.0")
    eng = LocalEngine(pipeline_workers=2, pipeline_mode="process")
    reg = default_registry()
    before = reg.snapshot()
    try:
        with pytest.raises(PipelineWorkerError, match="broke"):
            _port_df(_parts([3] * 3), eng).map_batches(
                _port_ident).collect()
        assert eng._host_pipeline().describe()["process_pool_broken"]
        out = _port_df(_parts([3] * 3), eng).map_batches(
            _port_ident).collect()
        np.testing.assert_array_equal(out["id"], np.arange(9))
        assert _delta(reg, before, "pipeline.fallbacks") >= 2
    finally:
        eng.shutdown()


def test_live_resize_keeps_the_old_generation_alive():
    """Moving ``pipeline_workers`` mid-stream builds a new pool
    generation; the open stream finishes on its own, which shuts down
    when it lets go."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    eng = LocalEngine(pipeline_workers=2, pipeline_mode="thread",
                      pipeline_read_ahead=2)
    try:
        it = _port_df(_parts([10] * 6), eng).map_batches(
            _port_ident).stream()
        first = next(it)
        hp = eng._host_pipeline()
        gen_a = hp._thread_handle
        assert gen_a is not None and gen_a.refs >= 1
        eng.pipeline_workers = 3
        out_b = _port_df(_parts([10] * 3), eng).map_batches(
            _port_ident).collect()
        assert len(out_b["id"]) == 30
        assert hp._thread_handle is not gen_a
        assert gen_a.retired and gen_a.refs >= 1
        got = [first] + list(it)
        np.testing.assert_array_equal(
            np.concatenate([b["id"] for b in got]), np.arange(60))
        assert gen_a.refs == 0
    finally:
        eng.shutdown()


def test_state_and_describe_have_the_jax_keys(port_process, jax_process):
    from sparkdl_tpu.data import pipeline as jax_pipeline
    from sparkdl_tpu_torch.data import pipeline
    _port_df(_parts([3] * 2), port_process).map_batches(
        _port_ident).collect()
    _jax_df(_parts([3] * 2), jax_process).map_batches(
        lambda b: b).collect()
    assert set(port_process._host_pipeline().describe()) == \
        set(jax_process._host_pipeline().describe())
    state, ref = pipeline.state(), jax_pipeline.state()
    assert {"mode", "workers", "read_ahead", "shm_min_bytes",
            "streams_active", "counters"} <= set(state) <= set(ref)
    assert all(k.startswith("pipeline.") for k in state["counters"])


def test_engine_pickles_without_its_pools(port_process):
    """Pools, locks and the retry budget stay behind; the knobs travel,
    and the copy builds its own pool on first use."""
    from sparkdl_tpu_torch.data.engine import LocalEngine
    _port_df(_parts([3] * 2), port_process).map_batches(
        _port_ident).collect()
    clone = pickle.loads(pickle.dumps(port_process))
    try:
        assert clone._pipeline is None
        assert (clone.pipeline_workers, clone.pipeline_read_ahead,
                clone.pipeline_mode, clone.inputsvc_endpoints) == \
            (port_process.pipeline_workers,
             port_process.pipeline_read_ahead, "process", [])
        clone.pipeline_mode = "thread"
        clone._pipeline = None
        out = _port_df(_parts([3] * 2), clone).map_batches(
            _port_ident).collect()
        np.testing.assert_array_equal(out["id"], np.arange(6))
        assert isinstance(clone, LocalEngine)
    finally:
        clone.shutdown()


@pytest.mark.parametrize("rows", [0, 1, 5])
def test_codec_round_trips_columns(rows):
    from sparkdl_tpu_torch.data.codec import decode_batch, encode_batch
    rng = np.random.default_rng(rows)
    obj = np.empty(rows, dtype=object)
    obj[:] = [{"origin": f"img_{i}", "data": bytes([i])} if i % 2 else None
              for i in range(rows)]
    batch = {
        "u8": rng.integers(0, 256, (rows, 4, 6, 3), dtype=np.uint8),
        "f32": rng.normal(size=(rows, 7)).astype(np.float32),
        "i64": rng.integers(-5, 5, rows).astype(np.int64),
        "strided": rng.normal(size=(rows, 6)).astype(np.float32)[:, ::2],
        "obj": obj,
        "paths": np.array([f"/p/{i}.jpg" for i in range(rows)],
                          dtype=object),
    }
    for wire in (bytes, bytearray):
        out = decode_batch(wire(encode_batch(batch)))
        assert list(out) == list(batch)
        for name, col in batch.items():
            assert out[name].dtype == col.dtype
            assert out[name].shape == col.shape
            if col.dtype == object:
                assert list(out[name]) == list(col)
            else:
                assert out[name].tobytes() == np.ascontiguousarray(
                    col).tobytes()
                # views over the message: writable when it is
                assert not rows or \
                    out[name].flags.writeable == (wire is bytearray)


def test_codec_refuses_foreign_bytes():
    from sparkdl_tpu_torch.data.codec import (
        CodecError,
        decode_batch,
        encode_batch,
    )
    with pytest.raises(CodecError):
        decode_batch(b"ARW1" + bytes(20))
    with pytest.raises(CodecError):
        decode_batch(b"SD")
    good = encode_batch({"x": np.arange(10)})
    with pytest.raises(CodecError):
        decode_batch(good[:-8])


def test_read_images_and_featurizer_in_process_mode_match_jax(
        tmp_path, monkeypatch, port_process, jax_process):
    """``readImages`` → ``DeepImageFeaturizer(TestNet)`` with the host
    prefix (file read, PNG decode, the broken-file filter, the pack) on
    the process pool, against the JAX package's process pool on the
    same files: the same paths, features within ``TOL_FEATURES``, the
    same runner batch counts, and no fallback to threads."""
    from PIL import Image
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu.data.tensors import arrow_to_tensor
    from sparkdl_tpu_torch.obs import default_registry
    monkeypatch.setenv("SPARKDL_TPU_MODEL_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("SPARKDL_TPU_TORCH_MODEL_CACHE",
                       str(tmp_path / "torch"))
    d = tmp_path / "pngs"
    d.mkdir()
    rng = np.random.default_rng(5)
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                        "RGB").save(d / f"img_{i:02d}.png")
    (d / "broken.png").write_bytes(b"not an image")
    kw = dict(inputCol="image", outputCol="features", modelName="TestNet",
              batchSize=4)
    reg = default_registry()
    before = reg.snapshot()
    ref_featurizer = sparkdl_tpu.DeepImageFeaturizer(**kw)
    table = ref_featurizer.transform(sparkdl_tpu.readImages(
        str(d), numPartitions=4, engine=jax_process)).collect()
    idx = table.schema.get_field_index("features")
    ref = arrow_to_tensor(table.column(idx), table.schema.field(idx))
    featurizer = sparkdl_tpu_torch.DeepImageFeaturizer(device="cpu", **kw)
    out = featurizer.transform(sparkdl_tpu_torch.readImages(
        str(d), numPartitions=4, engine=port_process)).collect()
    assert list(out["filePath"]) == table.column("filePath").to_pylist()
    assert len(out["filePath"]) == 10
    assert out["features"].shape == ref.shape == (10, 16)
    np.testing.assert_allclose(out["features"], ref, rtol=0,
                               atol=TOL_FEATURES * np.abs(ref).max())
    assert featurizer.metrics.batches == ref_featurizer.metrics.batches
    assert _delta(reg, before, "pipeline.fallbacks") == 0
    assert _delta(reg, before, "pipeline.tasks") == 4


def test_port_sources_and_host_stages_pickle(tmp_path, monkeypatch):
    """What the port builds itself — ``from_columns``' and ``filesToDF``'s
    sources (an empty file list's too), ``filter`` / ``select`` /
    ``drop``, ``readImages``' decode and failure filter, and
    ``ImageTransformer``'s pack stage — pickles with the standard
    library, and the copy gives the same batches."""
    from PIL import Image
    from sparkdl_tpu_torch import ImageTransformer, readImages
    from sparkdl_tpu_torch.data.frame import DataFrame, apply_plan
    from sparkdl_tpu_torch.image.imageIO import filesToDF
    from sparkdl_tpu_torch.models import zoo
    monkeypatch.setenv("SPARKDL_TPU_TORCH_MODEL_CACHE", str(tmp_path / "c"))
    rng = np.random.default_rng(2)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8),
                        "RGB").save(tmp_path / f"img_{i}.png")
    (tmp_path / "broken.png").write_bytes(b"nope")
    mf = zoo.getModelFunction("TestNet", featurize=True, device="cpu")
    frames = {
        "from_columns": DataFrame.from_columns(
            {"id": np.arange(9), "x": np.arange(9.0)}, 3)
        .filter(_port_keep).select("x", "id").drop("x"),
        "filesToDF": filesToDF([str(tmp_path / "img_0.png")]),
        "filesToDF_empty": filesToDF([]),
        "readImages_pack": ImageTransformer(
            inputCol="image", outputCol="f", modelFunction=mf).transform(
            readImages(str(tmp_path), numPartitions=2)),
    }
    for name, df in frames.items():
        host = [st for st in df._plan if st.kind != "device"]
        sources, plan = pickle.loads(pickle.dumps((df._sources, host)))
        for i, (src, copy) in enumerate(zip(df._sources, sources)):
            want = apply_plan(host, src.load(), i)
            got = apply_plan(plan, copy.load(), i)
            assert list(got) == list(want), name
            for col in want:
                if want[col].dtype == object:
                    assert list(map(repr, got[col])) == \
                        list(map(repr, want[col])), (name, col)
                else:
                    np.testing.assert_array_equal(got[col], want[col])
