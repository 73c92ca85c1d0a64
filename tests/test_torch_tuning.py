"""The port's tuning (``ParamGridBuilder``, ``CrossValidator``,
``TrainValidationSplit``) and the frame operations it rests on, against
the JAX package on the CPU.

Fold and split membership is drawn from the same seeded generators, so
it must equal the JAX package's row for row. The tuned metrics come from
fits that start from the same weights (the JAX package's draw, carried
across) and differ only in summation order: ``TOL_METRIC`` on the
averaged loss, and the same best candidate.
"""

import logging

import numpy as np
import pyarrow as pa
import pytest

from sparkdl_tpu.data.frame import DataFrame as JDataFrame
from sparkdl_tpu.data.tensors import append_tensor_column as j_append
from sparkdl_tpu.estimators import evaluators as jev
from sparkdl_tpu.estimators.logistic_regression import (
    LogisticRegression as JLR,
)
from sparkdl_tpu.params import pipeline as jpipe
from sparkdl_tpu.params import tuning as jtun
from sparkdl_tpu_torch.data.frame import DataFrame as TDataFrame
from sparkdl_tpu_torch.data.frame import Source as TSource
from sparkdl_tpu_torch.estimators import evaluators as tev
from sparkdl_tpu_torch.estimators.logistic_regression import (
    LogisticRegression as TLR,
)
from sparkdl_tpu_torch.params import pipeline as tpipe
from sparkdl_tpu_torch.params import tuning as ttun

TOL_METRIC = 1e-4

UNEVEN = (5, 0, 17, 3, 9, 1, 12, 7, 0, 20, 2, 6)


def jax_init(self, n_features, n_classes):
    params, _, _ = JLR(seed=self.getOrDefault("seed"))._init_params(
        n_features, n_classes)
    return np.asarray(params["W"]), np.asarray(params["b"])


@pytest.fixture
def carried_init(monkeypatch):
    monkeypatch.setattr(TLR, "_init_params", jax_init)


def uneven_frames(sizes=UNEVEN):
    """Partitions of the given sizes with an ``id`` column: (JAX, port)."""
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    parts = [np.arange(lo, hi, dtype=np.int64)
             for lo, hi in zip(bounds[:-1], bounds[1:])]
    jdf = JDataFrame.from_batches(
        [pa.RecordBatch.from_pydict({"id": pa.array(p, pa.int64())})
         for p in parts])
    tdf = TDataFrame([TSource(lambda p=p: {"id": p}, len(p))
                      for p in parts])
    return jdf, tdf


def ids(df, jax):
    if jax:
        return df.collect().column("id").to_pylist()
    return df.collect()["id"].tolist()


@pytest.mark.parametrize("k,seed", [(3, 42), (5, 7)])
def test_fold_membership_equals_jax_row_for_row(k, seed):
    jdf, tdf = uneven_frames()
    seen = []
    for fold in range(k):
        for keep_train in (True, False):
            ref = ids(jtun._fold_split(jdf, k, fold, seed, keep_train), True)
            got = ids(ttun._fold_split(tdf, k, fold, seed, keep_train), False)
            assert got == ref
            if not keep_train:
                seen += got
    assert sorted(seen) == list(range(sum(UNEVEN)))


@pytest.mark.parametrize("ratio,seed", [(0.75, 42), (0.5, 3)])
def test_tvs_membership_equals_jax_row_for_row(ratio, seed):
    jdf, tdf = uneven_frames()
    jtr, jva = jtun.TrainValidationSplit(trainRatio=ratio, seed=seed) \
        ._split(jdf)
    ttr, tva = ttun.TrainValidationSplit(trainRatio=ratio, seed=seed) \
        ._split(tdf)
    assert ids(ttr, False) == ids(jtr, True)
    assert ids(tva, False) == ids(jva, True)
    assert sorted(ids(ttr, False) + ids(tva, False)) == \
        list(range(sum(UNEVEN)))


def test_partition_order_keeps_each_partition_identity():
    """A reordered frame draws each partition's fold ids as the JAX
    package's reordered frame does (the logical index travels along)."""
    jdf, tdf = uneven_frames()
    order = [9, 2, 2, 0, 11]
    ref = ids(jtun._fold_split(jdf.with_partition_order(order), 3, 1, 5,
                               True), True)
    got = ids(ttun._fold_split(tdf.with_partition_order(order), 3, 1, 5,
                               True), False)
    assert got == ref
    with pytest.raises(IndexError, match="out of range"):
        tdf.with_partition_order([12])


def test_param_grids_equal_jax():
    def grid(LR, builder):
        b = builder().addGrid(LR.regParam, [0.0, 0.01]) \
            .addGrid(LR.maxIter, [5, 10]).baseOn({LR.seed: 3})
        return [{p.name: v for p, v in m.items()} for m in b.build()]

    assert grid(TLR, ttun.ParamGridBuilder) == \
        grid(JLR, jtun.ParamGridBuilder)
    assert ttun.ParamGridBuilder().build() == [{}]


def feature_frames(n=150, d=8, c=3, seed=2, parts=6):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    X = (rng.normal(0, 0.7, (c, d))[y] + rng.normal(0, 1, (n, d))) \
        .astype(np.float32)
    batch = j_append(pa.RecordBatch.from_pydict({"label": pa.array(y)}),
                     "features", X)
    return (JDataFrame.from_table(pa.Table.from_batches([batch]), parts),
            TDataFrame.from_columns({"label": y, "features": X}, parts))


def _grid(LR, builder):
    return builder().addGrid(LR.regParam, [0.0, 0.05]) \
        .addGrid(LR.maxIter, [3, 15]).build()


@pytest.mark.parametrize("tuner,evaluator", [
    ("CrossValidator", "LossEvaluator"),
    ("CrossValidator", "ClassificationEvaluator"),
    ("TrainValidationSplit", "LossEvaluator"),
])
def test_tuned_metrics_match_jax(tuner, evaluator, carried_init):
    jdf, tdf = feature_frames()
    jm = getattr(jtun, tuner)(
        estimator=JLR(), estimatorParamMaps=_grid(JLR, jtun.ParamGridBuilder),
        evaluator=getattr(jev, evaluator)()).fit(jdf)
    tm = getattr(ttun, tuner)(
        estimator=TLR(device="cpu"),
        estimatorParamMaps=_grid(TLR, ttun.ParamGridBuilder),
        evaluator=getattr(tev, evaluator)()).fit(tdf)
    name = "avgMetrics" if tuner == "CrossValidator" else "validationMetrics"
    ref, got = getattr(jm, name), getattr(tm, name)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_METRIC)
    larger = getattr(tev, evaluator)().isLargerBetter()
    pick = np.argmax if larger else np.argmin
    assert pick(got) == pick(ref)
    # the refit best model ran the same number of steps
    assert len(tm.bestModel.objectiveHistory) == \
        len(jm.bestModel.objectiveHistory)


class _Identity:
    """Stub stages of each package: a model that passes rows through."""

    @staticmethod
    def estimator(pkg):
        class M(pkg.Model):
            def _transform(self, dataset):
                return dataset

        class E(pkg.Estimator):
            def _fit(self, dataset):
                return M()

        return E()

    @staticmethod
    def evaluator(pkg, empty_calls, calls):
        class Ev(pkg.Evaluator):
            def _evaluate(self, dataset):
                calls.append(None)
                if len(calls) - 1 in empty_calls:
                    raise pkg.EmptyScoredFrameError("empty fold")
                return float(len(calls))

        return Ev()


@pytest.mark.parametrize("empty_calls", [{1}, {0, 3, 5}, set(range(6))],
                         ids=["one_fold", "every_fold_once", "all"])
def test_empty_fold_exclusion_matches_jax(empty_calls, caplog):
    """Folds some candidate scored empty leave every candidate's
    average, with the same warnings; no common fold raises the same
    error."""
    jdf, tdf = feature_frames(n=30)
    results = []
    for pkg, tun, df in ((jpipe, jtun, jdf), (tpipe, ttun, tdf)):
        caplog.clear()
        cv = tun.CrossValidator(
            estimator=_Identity.estimator(pkg),
            estimatorParamMaps=[{}, {}],
            evaluator=_Identity.evaluator(pkg, empty_calls, []),
            numFolds=3)
        with caplog.at_level(logging.WARNING):
            try:
                results.append(("ok", cv.fit(df).avgMetrics))
            except ValueError as e:
                results.append(("raised", str(e)))
        results[-1] += ([r.getMessage() for r in caplog.records],)
    assert results[1][0] == results[0][0]
    assert results[1][1] == results[0][1]
    assert results[1][2] == results[0][2]


def test_tvs_empty_validation_raises_like_jax():
    jdf, tdf = feature_frames(n=30)
    errs = []
    for pkg, tun, df in ((jpipe, jtun, jdf), (tpipe, ttun, tdf)):
        with pytest.raises(ValueError) as err:
            tun.TrainValidationSplit(
                estimator=_Identity.estimator(pkg),
                estimatorParamMaps=[{}],
                evaluator=_Identity.evaluator(pkg, {0}, [])).fit(df)
        errs.append(str(err.value))
    assert errs[0] == errs[1]


def test_collect_sub_models_layout():
    _, tdf = feature_frames(n=30)
    cv = ttun.CrossValidator(
        estimator=_Identity.estimator(tpipe), estimatorParamMaps=[{}, {}],
        evaluator=_Identity.evaluator(tpipe, set(), []), numFolds=2,
        collectSubModels=True).fit(tdf)
    assert [len(f) for f in cv.subModels] == [2, 2]
    tvs = ttun.TrainValidationSplit(
        estimator=_Identity.estimator(tpipe), estimatorParamMaps=[{}] * 3,
        evaluator=_Identity.evaluator(tpipe, set(), [])).fit(tdf)
    assert tvs.subModels is None and len(tvs.validationMetrics) == 3


@pytest.mark.parametrize("tuner", ["CrossValidator", "TrainValidationSplit"])
def test_cache_dir_spill_gives_the_in_memory_metrics(tuner, tmp_path):
    _, tdf = feature_frames()
    kw = dict(estimator=TLR(device="cpu"),
              estimatorParamMaps=_grid(TLR, ttun.ParamGridBuilder),
              evaluator=tev.LossEvaluator())
    name = "avgMetrics" if tuner == "CrossValidator" else "validationMetrics"
    mem = getattr(getattr(ttun, tuner)(**kw).fit(tdf), name)
    spilled = getattr(getattr(ttun, tuner)(cacheDir=str(tmp_path), **kw)
                      .fit(tdf), name)
    assert spilled == mem
    assert list(tmp_path.iterdir()) == []    # the spill is removed


# ---------------------------------------------------------------------------
# the frame operations tuning and the estimator read
# ---------------------------------------------------------------------------

def test_cache_to_disk_round_trips_and_refuses_other_frames(tmp_path):
    structs = np.empty(4, dtype=object)
    structs[:] = [{"origin": f"r{i}", "data": bytes([i])} for i in range(4)]
    runs = []

    def total(b):
        runs.append(len(b["x"]))
        return {**b, "y": b["x"].sum(1)}

    df = TDataFrame.from_columns({
        "x": np.arange(8, dtype=np.float32).reshape(4, 2),
        "s": structs}, 2).map_batches(total, name="sum")
    spill = df.cache_to_disk(str(tmp_path / "c"))
    assert spill.schema_probe_free and spill.known_count() == 4
    first, second = spill.collect(), spill.collect()
    assert sorted(runs) == [0, 2, 2]   # the schema probe, then each once
    ref = df.collect()
    for out in (first, second):
        assert list(out) == ["x", "s", "y"]
        np.testing.assert_array_equal(out["x"], ref["x"])
        np.testing.assert_array_equal(out["y"], ref["y"])
        assert list(out["s"]) == list(ref["s"])
    assert sorted(p.name for p in (tmp_path / "c").iterdir()) == \
        ["_manifest.json", "part_00000.npz", "part_00001.npz"]
    with pytest.raises(ValueError, match="DIFFERENT frame"):
        df.select("x").cache_to_disk(str(tmp_path / "c"))
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "other").write_text("x")
    with pytest.raises(ValueError, match="no spill manifest"):
        df.cache_to_disk(str(tmp_path / "d"))


def test_cache_runs_the_plan_once():
    runs = []
    df = TDataFrame.from_columns({"a": np.arange(10)}, 3).map_batches(
        lambda b: (runs.append(1), b)[1])
    cached = df.cache()
    assert len(runs) == 3 and cached.num_partitions == 3
    assert cached.collect()["a"].tolist() == list(range(10))
    assert cached.collect()["a"].tolist() == list(range(10))
    assert len(runs) == 3


def test_select_drop_and_collect_rules_match_jax():
    """select/drop as in the JAX package; collect drops zero-row batches
    beside populated ones, keeps one when all are empty, and shows every
    batch to ``on_batch``."""
    jdf, tdf = feature_frames(n=12, parts=4)
    t = tdf.select("features", "label").drop("label").collect()
    j = jdf.select("features", "label").drop("label").collect()
    assert list(t) == j.column_names == ["features"]
    with pytest.raises(KeyError, match="nope"):
        tdf.select("nope").collect()
    seen = []
    odd = tdf.map_batches(
        lambda b, i: b if i % 2 else {k: v[:0].reshape(0) for k, v in
                                      b.items()}, with_index=True)
    out = odd.collect(on_batch=lambda b: seen.append(len(b["label"])))
    assert seen == [0, 3, 0, 3]
    assert out["features"].shape == (6, 8)
    empty = tdf.filter(lambda b: np.zeros(len(b["label"]), bool)).collect()
    assert list(empty) == ["label", "features"]
    assert len(empty["label"]) == 0 and empty["features"].shape == (0, 8)


@pytest.mark.parametrize("kind,known,free", [
    ("in_memory", 12, True), ("planned", 12, True),
    ("filtered", None, True), ("hintless", 12, False)])
def test_known_count_and_probe_freedom_match_jax(kind, known, free):
    jdf, tdf = feature_frames(n=12, parts=3)
    if kind == "planned":
        jdf, tdf = jdf.select("label", "features"), \
            tdf.select("label", "features")
    elif kind == "filtered":
        jdf = jdf.filter(lambda b: np.ones(b.num_rows, bool))
        tdf = tdf.filter(lambda b: np.ones(len(b["label"]), bool))
    elif kind == "hintless":
        jb = jdf.collect().to_batches()[0]
        jdf = JDataFrame([type(jdf._sources[0])(lambda: jb, 12)])
        tb = tdf.collect()
        tdf = TDataFrame([TSource(lambda: tb, 12)])
    assert tdf.known_count() == jdf.known_count() == known
    assert tdf.schema_probe_free == jdf.schema_probe_free == free
    assert tdf.count() == jdf.count() == 12
    assert list(tdf.schema) == list(jdf.schema.names)
    assert tdf.schema["features"].shape == (0, 8)
