"""The port's transfer-learning estimators against the JAX package on the
CPU: ``LogisticRegression`` in its three training modes from the same
initial weights (the JAX package's own draw, carried across by patching
the port's ``_init_params``), the fitted model's layouts, the label
checks, the memory-budget switch, and every evaluator metric on the same
scored columns.

Tolerances: the two optimisers are the same Adam update in float32 and
differ only in summation order, so over these small fits the objective
history agrees within ``TOL_HISTORY`` relative, the coefficients within
``TOL_COEF`` of the largest |W|, and the probabilities within
``TOL_PROB`` absolute (a probe at 512 × 2048, 10 classes, 100 steps
showed about a tenth of each). The evaluators run the same float64
numpy arithmetic on the same columns: ``TOL_METRIC``.
"""

import logging

import numpy as np
import pyarrow as pa
import pytest

from sparkdl_tpu.data.frame import DataFrame as JDataFrame
from sparkdl_tpu.data.frame import Source as JSource
from sparkdl_tpu.data.tensors import append_tensor_column as j_append
from sparkdl_tpu.data.tensors import arrow_to_tensor
from sparkdl_tpu.estimators import evaluators as jev
from sparkdl_tpu.estimators.logistic_regression import (
    LogisticRegression as JLR,
)
from sparkdl_tpu.params.pipeline import EmptyScoredFrameError as JEmpty
from sparkdl_tpu_torch.data.frame import DataFrame as TDataFrame
from sparkdl_tpu_torch.data.frame import Source as TSource
from sparkdl_tpu_torch.estimators import evaluators as tev
from sparkdl_tpu_torch.estimators.logistic_regression import (
    LogisticRegression as TLR,
)
from sparkdl_tpu_torch.estimators.logistic_regression import from_jax_params
from sparkdl_tpu_torch.params.pipeline import EmptyScoredFrameError as TEmpty

TOL_HISTORY = 1e-4
TOL_COEF = 1e-3
TOL_PROB = 1e-5
TOL_METRIC = 1e-12


def jax_init(self, n_features, n_classes):
    """The JAX package's initial (W, b) for this estimator's seed."""
    params, _, _ = JLR(seed=self.getOrDefault("seed"))._init_params(
        n_features, n_classes)
    return np.asarray(params["W"]), np.asarray(params["b"])


@pytest.fixture
def carried_init(monkeypatch):
    monkeypatch.setattr(TLR, "_init_params", jax_init)


def blobs(n=200, d=16, c=3, seed=0):
    """Overlapping Gaussian classes: features float32 [n, d], labels.
    The classes overlap enough that the loss stays near 0.05 over the
    fits here: on separable data it falls towards 0 and the relative
    history difference of two summation orders grows as it does."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    centers = rng.normal(0, 0.7, (c, d))
    X = (centers[y] + rng.normal(0, 1, (n, d))).astype(np.float32)
    return X, y


def frames(columns, parts=4):
    """The same columns as a frame of each package: (JAX, port). 2-D
    numeric columns become tensor columns on the JAX side."""
    scalars = {k: pa.array(v) for k, v in columns.items()
               if np.asarray(v).ndim == 1}
    batch = pa.RecordBatch.from_pydict(scalars)
    for k, v in columns.items():
        if np.asarray(v).ndim > 1:
            batch = j_append(batch, k, np.asarray(v))
    order = list(columns)
    batch = batch.select(order)
    return (JDataFrame.from_table(pa.Table.from_batches([batch]), parts),
            TDataFrame.from_columns({k: np.asarray(v)
                                     for k, v in columns.items()}, parts))


def jax_col(df, name):
    table = df.collect()
    idx = table.schema.get_field_index(name)
    return np.asarray(arrow_to_tensor(table.column(idx),
                                      table.schema.field(idx)))


def assert_fits_agree(jm, tm, jdf, tdf):
    np.testing.assert_allclose(tm.objectiveHistory, jm.objectiveHistory,
                               rtol=TOL_HISTORY)
    assert len(tm.objectiveHistory) == len(jm.objectiveHistory)
    np.testing.assert_allclose(
        tm.coefficients, jm.coefficients, rtol=0,
        atol=TOL_COEF * np.abs(jm.coefficients).max())
    np.testing.assert_allclose(
        tm.intercept, jm.intercept, rtol=0,
        atol=TOL_COEF * np.abs(jm.coefficients).max())
    jp = jax_col(jm.transform(jdf), "probability")
    out = tm.transform(tdf).collect()
    assert out["probability"].dtype == np.float32
    assert out["prediction"].dtype == np.float64
    np.testing.assert_allclose(out["probability"], jp, rtol=0,
                               atol=TOL_PROB)
    np.testing.assert_array_equal(out["prediction"],
                                  jax_col(jm.transform(jdf), "prediction"))


@pytest.mark.parametrize("kw", [
    dict(maxIter=40),
    dict(maxIter=40, regParam=1e-2, learningRate=0.05, seed=3),
    dict(maxIter=5, batchSize=48),                     # 200 = 4×48 + 8
    dict(maxIter=5, batchSize=48, streaming=True),
    dict(maxIter=4, batchSize=32, streaming=True, numClasses=3),
], ids=["full_batch", "full_batch_reg", "minibatch_ragged", "streaming",
        "streaming_declared"])
def test_fit_matches_jax(kw, carried_init):
    X, y = blobs()
    jdf, tdf = frames({"label": y, "features": X}, parts=5)
    jm = JLR(**kw).fit(jdf)
    tm = TLR(device="cpu", **kw).fit(tdf)
    expected = ("streaming" if kw.get("streaming")
                else "minibatch" if kw.get("batchSize") else "full_batch")
    assert tm.fitStats["mode"] == expected
    assert tm.fitStats["device"] == "cpu"
    assert_fits_agree(jm, tm, jdf, tdf)


def test_default_init_is_seeded_on_the_cpu():
    """Without the carried draw, two fits from one seed start and end on
    the same bits, and another seed differs."""
    X, y = blobs(n=60)
    _, tdf = frames({"label": y, "features": X})
    a, b = (TLR(maxIter=3, device="cpu").fit(tdf) for _ in range(2))
    np.testing.assert_array_equal(a.coefficients, b.coefficients)
    W0, _ = TLR(seed=1)._init_params(16, 3)
    assert not np.array_equal(np.asarray(W0),
                              np.asarray(TLR()._init_params(16, 3)[0]))


def test_from_jax_params_scores_like_the_jax_model():
    X, y = blobs()
    jdf, tdf = frames({"label": y, "features": X})
    jm = JLR(maxIter=20).fit(jdf)
    tm = from_jax_params(jm.coefficients, jm.intercept)
    np.testing.assert_allclose(tm.transform(tdf).collect()["probability"],
                               jax_col(jm.transform(jdf), "probability"),
                               rtol=0, atol=1e-6)
    assert tm.numClasses == jm.numClasses == 3


@pytest.mark.parametrize("y", [
    np.zeros((3, 2)),
    np.array([0.0, 1.5, 1.0]),
    np.array(["a", "b"]),
    np.array([0, -1, 2]),
    np.array([0, None], dtype=object),
], ids=["2d", "fraction", "strings", "negative", "object"])
def test_clean_labels_refuses_what_jax_refuses(y):
    with pytest.raises(ValueError) as jerr:
        JLR._clean_labels(y)
    with pytest.raises(ValueError) as terr:
        TLR._clean_labels(y)
    assert str(terr.value) == str(jerr.value)


def test_fit_refuses_fractional_labels_like_jax():
    X, _ = blobs(n=20)
    y = np.linspace(0, 1, 20)
    jdf, tdf = frames({"label": y, "features": X})
    with pytest.raises(ValueError) as jerr:
        JLR(maxIter=1).fit(jdf)
    with pytest.raises(ValueError) as terr:
        TLR(maxIter=1, device="cpu").fit(tdf)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kw", [dict(), dict(batchSize=16, streaming=True)],
                         ids=["collected", "streaming"])
def test_declared_num_classes_and_binomial_layout(kw, carried_init):
    X, y = blobs(n=80, c=2)
    jdf, tdf = frames({"label": y, "features": X})
    jm = JLR(maxIter=10, **kw).fit(jdf)
    tm = TLR(maxIter=10, device="cpu", **kw).fit(tdf)
    assert tm.coefficientMatrix.shape == jm.coefficientMatrix.shape \
        == (1, 16)
    np.testing.assert_array_equal(
        tm.coefficientMatrix[0], tm.coefficients[:, 1] - tm.coefficients[:, 0])
    np.testing.assert_allclose(tm.coefficientMatrix, jm.coefficientMatrix,
                               rtol=0, atol=2 * TOL_COEF
                               * np.abs(jm.coefficients).max())
    assert tm.interceptVector.shape == (1,)
    # a declared count wider than the labels is kept
    wide = TLR(maxIter=2, numClasses=5, device="cpu", **kw).fit(tdf)
    assert wide.numClasses == JLR(maxIter=2, numClasses=5, **kw).fit(
        jdf).numClasses == 5
    assert wide.coefficientMatrix.shape == (5, 16)
    # numClasses=1 over all-zero labels widens to 2
    zeros = np.zeros(len(y), np.int64)
    jz, tz = frames({"label": zeros, "features": X})
    assert TLR(maxIter=2, numClasses=1, device="cpu", **kw).fit(
        tz).numClasses == JLR(maxIter=2, numClasses=1, **kw).fit(
        jz).numClasses == 2
    # a label beyond the declared count raises in both
    with pytest.raises(ValueError) as jerr:
        JLR(maxIter=1, numClasses=1, **kw).fit(jdf)
    with pytest.raises(ValueError) as terr:
        TLR(maxIter=1, numClasses=1, device="cpu", **kw).fit(tdf)
    assert str(terr.value) == str(jerr.value)


def _budget_frames(kind):
    X, y = blobs(n=64, d=8, c=2, seed=3)
    jdf, tdf = frames({"label": y.astype(np.float64), "features": X})
    if kind == "filtered":      # the row count is unknown for free
        return (jdf.filter(lambda b: np.ones(b.num_rows, bool)),
                tdf.filter(lambda b: np.ones(len(b["label"]), bool)))
    if kind == "planned":       # a row-preserving stage over the hint
        return jdf.select("features", "label"), tdf.select("features",
                                                           "label")
    if kind == "hintless":      # the schema probe would load a partition
        jb = jdf.collect().to_batches()[0]
        tb = tdf.collect()
        return (JDataFrame([JSource(lambda: jb, jb.num_rows)]),
                TDataFrame([TSource(lambda: tb, len(tb["label"]))]))
    return jdf, tdf


@pytest.mark.parametrize("kind,budget,switches,buffered", [
    ("in_memory", 1024, True, False),
    ("planned", 1024, True, False),
    ("filtered", 512, False, True),
    ("hintless", 512, False, True),
    ("in_memory", 0, False, False),
    ("in_memory", None, False, False),       # the 1 GiB default
])
def test_budget_switch_fires_for_the_same_frames(kind, budget, switches,
                                                 buffered, caplog):
    kw = {} if budget is None else {"memoryBudgetBytes": budget}
    texts = []
    for LR, df, extra in zip((JLR, TLR), _budget_frames(kind),
                             ({}, {"device": "cpu"})):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            model = LR(maxIter=2, **kw, **extra).fit(df)
        assert model.numClasses == 2
        texts.append(caplog.text)
    for text in texts:
        assert ("auto-switching to the streaming fit" in text) == switches
        assert ("buffered" in text) == buffered
    assert TLR._DEFAULT_BUDGET == JLR._DEFAULT_BUDGET == 1 << 30


def test_budget_switch_never_collects(monkeypatch, caplog):
    _, tdf = _budget_frames("in_memory")
    monkeypatch.setattr(TDataFrame, "collect", lambda self, **kw: (
        _ for _ in ()).throw(AssertionError("the switch must not collect")))
    with caplog.at_level(logging.WARNING):
        model = TLR(maxIter=2, memoryBudgetBytes=1024, device="cpu").fit(tdf)
    assert model.fitStats["mode"] == "streaming"
    assert "auto-switching" in caplog.text


def test_default_device_raises_without_cuda():
    _, tdf = frames({"label": np.zeros(4, np.int64),
                     "features": np.zeros((4, 2), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TLR(maxIter=1).fit(tdf)


def test_misspelled_features_col_fails_like_jax(caplog):
    X, y = blobs(n=64, d=64, c=2)
    jdf, tdf = frames({"label": y, "features": X})
    with caplog.at_level(logging.WARNING):
        with pytest.raises(KeyError, match="featurs"):
            JLR(maxIter=1, featuresCol="featurs",
                memoryBudgetBytes=1024).fit(jdf)
        with pytest.raises(KeyError, match="featurs"):
            TLR(maxIter=1, featuresCol="featurs", memoryBudgetBytes=1024,
                device="cpu").fit(tdf)
    assert "auto-switching" not in caplog.text


# ---------------------------------------------------------------------------
# evaluators
# ---------------------------------------------------------------------------

def scored(n=90, c=3, seed=4):
    """Scored columns with ties: probability vectors, predicted labels,
    binary scores rounded to few distinct values, labels."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (n, c))
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y = rng.integers(0, c, n)
    yb = rng.integers(0, 2, n)
    score = np.round(rng.random(n), 1)            # ties
    p2 = np.stack([1 - score, score], 1).astype(np.float32)
    return {"label": y, "binlabel": yb,
            "probability": p.astype(np.float32),
            "prediction": p.argmax(1).astype(np.float64),
            "score": score, "p2": p2,
            "onehot": np.eye(c, dtype=np.float64)[y]}


CASES = [
    ("cls", dict(predictionCol="probability", metricName=m))
    for m in ("accuracy", "f1", "weightedPrecision", "weightedRecall")
] + [
    ("cls", dict(predictionCol="prediction", metricName="f1",
                 predictionSemantics=s)) for s in ("auto", "labels")
] + [
    ("cls", dict(predictionCol="score", labelCol="binlabel",
                 metricName="accuracy", predictionSemantics=s))
    for s in ("auto", "probabilities")
] + [
    ("cls", dict(predictionCol="probability", labelCol="onehot")),
    ("bin", dict(rawPredictionCol="score", labelCol="binlabel")),
    ("bin", dict(rawPredictionCol="score", labelCol="binlabel",
                 metricName="areaUnderPR")),
    ("bin", dict(rawPredictionCol="p2", labelCol="binlabel",
                 metricName="areaUnderPR")),
    ("loss", dict()),
    ("loss", dict(labelCol="onehot")),
    ("loss", dict(predictionCol="score", labelCol="binlabel")),
    ("loss", dict(predictionCol="score", labelCol="binlabel",
                  predictionSemantics="probabilities")),
]
KINDS = {"cls": "ClassificationEvaluator",
         "bin": "BinaryClassificationEvaluator", "loss": "LossEvaluator"}


@pytest.mark.parametrize("kind,kw", CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_evaluator_metrics_equal_jax(kind, kw):
    jdf, tdf = frames(scored(), parts=4)
    j = getattr(jev, KINDS[kind])(**kw)
    t = getattr(tev, KINDS[kind])(**kw)
    got, ref = t.evaluate(tdf), j.evaluate(jdf)
    assert abs(got - ref) <= TOL_METRIC
    assert t.isLargerBetter() == j.isLargerBetter()


def test_binary_evaluator_falls_back_to_probability_like_jax(caplog):
    cols = scored()
    cols = {"binlabel": cols["binlabel"], "probability": cols["p2"]}
    jdf, tdf = frames(cols)
    with caplog.at_level(logging.WARNING):
        ref = jev.BinaryClassificationEvaluator(labelCol="binlabel") \
            .evaluate(jdf)
        got = tev.BinaryClassificationEvaluator(labelCol="binlabel") \
            .evaluate(tdf)
    assert abs(got - ref) <= TOL_METRIC
    assert caplog.text.count("scoring 'probability' instead") == 2


@pytest.mark.parametrize("kind,kw,col,value", [
    ("cls", dict(predictionCol="probability"), "probability", np.nan),
    ("bin", dict(rawPredictionCol="score", labelCol="binlabel"), "score",
     np.inf),
    ("loss", dict(), "probability", np.nan),
    ("loss", dict(predictionCol="prediction"), None, None),
    ("cls", dict(predictionCol="score", metricName="accuracy",
                 predictionSemantics="labels"), None, None),
    ("bin", dict(rawPredictionCol="score"), None, None),
], ids=["cls-nan", "bin-inf", "loss-nan", "loss-on-labels",
        "cls-fraction-as-labels", "bin-multiclass-labels"])
def test_evaluators_refuse_what_jax_refuses(kind, kw, col, value):
    cols = scored()
    if col is not None:
        cols[col] = cols[col].copy()
        cols[col][5] = value
    jdf, tdf = frames(cols)
    with pytest.raises(ValueError) as jerr:
        getattr(jev, KINDS[kind])(**kw).evaluate(jdf)
    with pytest.raises(ValueError) as terr:
        getattr(tev, KINDS[kind])(**kw).evaluate(tdf)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("kind,kw", [
    ("cls", dict(predictionCol="probability")),
    ("cls", dict(predictionCol="prediction", predictionSemantics="labels")),
    ("bin", dict(rawPredictionCol="score", labelCol="binlabel")),
    ("loss", dict()),
])
def test_evaluators_refuse_empty_frames_like_jax(kind, kw):
    jdf, tdf = frames(scored())
    jdf = jdf.filter(lambda b: np.zeros(b.num_rows, bool))
    tdf = tdf.filter(lambda b: np.zeros(len(b["label"]), bool))
    with pytest.raises(JEmpty):
        getattr(jev, KINDS[kind])(**kw).evaluate(jdf)
    with pytest.raises(TEmpty):
        getattr(tev, KINDS[kind])(**kw).evaluate(tdf)


def test_evaluate_with_params_uses_a_copy():
    _, tdf = frames(scored())
    ev = tev.ClassificationEvaluator(predictionCol="probability")
    f1 = ev.evaluate(tdf, {"metricName": "f1"})
    assert ev.getOrDefault("metricName") == "accuracy"
    assert f1 == tev.ClassificationEvaluator(
        predictionCol="probability", metricName="f1").evaluate(tdf)
    with pytest.raises(TypeError, match="params must be a dict"):
        ev.evaluate(tdf, [1])


# ---------------------------------------------------------------------------
# params and pipeline semantics
# ---------------------------------------------------------------------------

def test_params_methods_match_jax():
    from sparkdl_tpu.params.base import TypeConverters as JTC
    from sparkdl_tpu_torch.params.base import TypeConverters as TTC
    j, t = JLR(maxIter=7), TLR(maxIter=7)
    assert t.hasParam("maxIter") and not t.hasParam("nope")
    assert t.explainParam("maxIter") == j.explainParam("maxIter")
    assert t.explainParam(TLR.regParam) == j.explainParam(JLR.regParam)
    with pytest.raises(ValueError, match="does not belong"):
        t.explainParam(tev.LossEvaluator.predictionCol)
    assert "device: " in t.explainParams()
    t.setParams(maxIter=9, regParam=0.5)
    j.setParams(maxIter=9, regParam=0.5)
    names = {p.name: v for p, v in t.extractParamMap().items()}
    jnames = {p.name: v for p, v in j.extractParamMap().items()}
    assert {k: v for k, v in names.items() if k != "device"} == jnames
    t.setParams(regParam=None)          # None clears back to the default
    assert t.getOrDefault("regParam") == 0.0
    with pytest.raises(AttributeError, match="no param 'nope'"):
        t.setParams(nope=1)
    other = t._copyValues(TLR())
    assert other.getOrDefault("maxIter") == 9
    for value in (1, 2.5, "x", True, [1], ("a", "b"), ["a", 1]):
        for conv in ("toFloat", "toList", "toListString"):
            try:
                ref = getattr(JTC, conv)(value)
            except TypeError as e:
                with pytest.raises(TypeError) as err:
                    getattr(TTC, conv)(value)
                assert str(err.value) == str(e)
            else:
                assert getattr(TTC, conv)(value) == ref


def test_fit_takes_a_dict_a_list_or_nothing():
    X, y = blobs(n=40)
    _, tdf = frames({"label": y, "features": X})
    lr = TLR(maxIter=2, device="cpu")
    assert len(lr.fit(tdf).objectiveHistory) == 2
    assert len(lr.fit(tdf, {TLR.maxIter: 3}).objectiveHistory) == 3
    assert lr.getOrDefault("maxIter") == 2
    models = lr.fit(tdf, [{"maxIter": 1}, {"maxIter": 4}])
    assert [len(m.objectiveHistory) for m in models] == [1, 4]
    assert [i for i, _ in lr.fitMultiple(tdf, [{}, {}])] == [0, 1]
    with pytest.raises(TypeError, match="params must be dict"):
        lr.fit(tdf, "maxIter")


def test_pipeline_fit_applies_stages_as_jax_does():
    """Stages before the last estimator transform the frame during fit;
    stages after it do not; a pipeline param map reaches the stage that
    owns the param, and an unclaimed entry raises."""
    from sparkdl_tpu.params import pipeline as jpipe
    from sparkdl_tpu_torch.params import pipeline as tpipe
    X, y = blobs(n=40)
    counts = []
    for pkg, LR, df, extra in ((jpipe, JLR, frames({"label": y,
                                                    "features": X})[0], {}),
                               (tpipe, TLR, frames({"label": y,
                                                    "features": X})[1],
                                {"device": "cpu"})):
        calls = []

        class Counting(pkg.Transformer):
            def __init__(self, name):
                super().__init__()
                self.name = name

            def _transform(self, dataset):
                calls.append(self.name)
                return dataset

        pipe = pkg.Pipeline(stages=[Counting("before"), LR(maxIter=2, **extra),
                                    Counting("after")])
        model = pipe.fit(df)
        assert [type(s).__name__ for s in model.stages] == \
            ["Counting", "LogisticRegressionModel", "Counting"]
        fitted = pipe.copy({LR.maxIter: 5}).fit(df)
        assert len(fitted.stages[1].objectiveHistory) == 5
        assert pipe.getStages()[1].getOrDefault("maxIter") == 2
        with pytest.raises(AttributeError, match="belong to neither"):
            pipe.copy({tev.LossEvaluator.labelCol if pkg is tpipe
                       else jev.LossEvaluator.labelCol: "y"})
        counts.append(calls)
    assert counts[0] == counts[1] == ["before", "before"]
