"""Save and load of the port's stages: a fitted ``LogisticRegressionModel``,
an unfitted ``Pipeline``, a fitted ``PipelineModel`` with the committed
TestNet featurizer, and a ``CrossValidatorModel``, each reloaded to the
same transform bits; and the refusals (overwrite, a directory that is no
saved stage, a class outside the trusted modules, a value that is
neither JSON nor an array)."""

import json

import numpy as np
import pytest

import sparkdl_tpu_torch
from sparkdl_tpu_torch import DataFrame, LogisticRegression, load_model
from sparkdl_tpu_torch.estimators.logistic_regression import (
    LogisticRegressionModel,
)
from sparkdl_tpu_torch.params.pipeline import Pipeline, PipelineModel


def feature_frame(n=60, d=6, seed=3):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    X = (rng.normal(0, 1, (n, d)) + 1.5 * y[:, None]).astype(np.float32)
    return DataFrame.from_columns({"label": y, "features": X}, 3)


def test_logistic_regression_model_round_trip(tmp_path):
    df = feature_frame()
    model = LogisticRegression(maxIter=30, device="cpu").fit(df)
    model.save(str(tmp_path / "lr"))
    meta = json.loads((tmp_path / "lr" / "metadata.json").read_text())
    assert meta["format"] == "sparkdl_tpu_torch.stage"
    assert meta["extra"]["coefficients"] == {
        "kind": "ndarray", "file": "extra_coefficients.npy"}
    back = load_model(str(tmp_path / "lr"))
    assert isinstance(back, LogisticRegressionModel)
    np.testing.assert_array_equal(back.coefficients, model.coefficients)
    assert back.objectiveHistory == model.objectiveHistory
    a, b = model.transform(df).collect(), back.transform(df).collect()
    np.testing.assert_array_equal(a["probability"], b["probability"])
    np.testing.assert_array_equal(a["prediction"], b["prediction"])


def test_unfitted_pipeline_round_trip(tmp_path):
    pipe = Pipeline(stages=[LogisticRegression(maxIter=15, regParam=0.1,
                                               device="cpu")])
    pipe.save(str(tmp_path / "p"))
    back = load_model(str(tmp_path / "p"))
    (lr,) = back.getStages()
    assert type(lr) is LogisticRegression
    assert lr.getOrDefault("maxIter") == 15
    assert lr.getOrDefault("regParam") == 0.1
    assert lr.getDevice() == "cpu"
    assert lr.getOrDefault("seed") == 0
    a = pipe.fit(feature_frame()).stages[0]
    b = back.fit(feature_frame()).stages[0]
    np.testing.assert_array_equal(a.coefficients, b.coefficients)


@pytest.fixture
def empty_caches(tmp_path, monkeypatch):
    """An empty weight cache: the port serves its committed TestNet."""
    monkeypatch.setenv("SPARKDL_TPU_TORCH_MODEL_CACHE",
                       str(tmp_path / "torch"))


def _testnet_frame(n=24, seed=0, parts=3):
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.models.testnet import synthetic_testnet_dataset
    x, y = synthetic_testnet_dataset(n, seed=seed)
    return DataFrame.from_pylist(
        [{"image": imageArrayToStruct(a, origin=f"r{i}"), "label": int(l)}
         for i, (a, l) in enumerate(zip(x, y))], parts)


def test_fitted_featurizer_pipeline_round_trip(tmp_path, empty_caches):
    df = _testnet_frame()
    fitted = Pipeline(stages=[
        sparkdl_tpu_torch.DeepImageFeaturizer(
            inputCol="image", outputCol="features", modelName="TestNet",
            batchSize=8, device="cpu"),
        LogisticRegression(maxIter=20, device="cpu"),
    ]).fit(df)
    fitted.save(str(tmp_path / "pm"))
    back = load_model(str(tmp_path / "pm"))
    assert isinstance(back, PipelineModel)
    assert [type(s).__name__ for s in back.stages] == \
        ["DeepImageFeaturizer", "LogisticRegressionModel"]
    feat = back.stages[0]
    assert feat.getOrDefault("modelName") == "TestNet"
    assert feat.getDevice() == "cpu" and feat.getBatchSize() == 8
    a, b = fitted.transform(df).collect(), back.transform(df).collect()
    for col in ("features", "probability", "prediction"):
        np.testing.assert_array_equal(a[col], b[col])


def test_cross_validator_model_round_trip(tmp_path):
    from sparkdl_tpu_torch import (
        ClassificationEvaluator,
        CrossValidator,
        ParamGridBuilder,
    )
    df = feature_frame()
    lr = LogisticRegression(device="cpu")
    cvm = CrossValidator(
        estimator=lr, numFolds=2, evaluator=ClassificationEvaluator(),
        estimatorParamMaps=ParamGridBuilder().addGrid(
            LogisticRegression.maxIter, [2, 10]).build()).fit(df)
    cvm.save(str(tmp_path / "cv"))
    back = load_model(str(tmp_path / "cv"))
    assert back.avgMetrics == [float(m) for m in cvm.avgMetrics]
    assert back.subModels is None
    np.testing.assert_array_equal(
        back.transform(df).collect()["probability"],
        cvm.transform(df).collect()["probability"])


def test_no_silent_overwrite(tmp_path):
    model = LogisticRegression(maxIter=1, device="cpu").fit(feature_frame())
    model.save(str(tmp_path / "m"))
    with pytest.raises(FileExistsError, match="fresh"):
        model.save(str(tmp_path / "m"))


def test_load_refuses_what_is_not_a_saved_stage(tmp_path):
    with pytest.raises(FileNotFoundError, match="metadata"):
        load_model(str(tmp_path))
    bogus = tmp_path / "bogus"
    bogus.mkdir()
    (bogus / "metadata.json").write_text(json.dumps({"format": "x"}))
    with pytest.raises(ValueError, match="not written"):
        load_model(str(bogus))


def test_load_refuses_a_jax_package_save(tmp_path):
    from sparkdl_tpu.estimators.logistic_regression import (
        LogisticRegressionModel as JaxModel,
    )
    JaxModel(np.zeros((3, 2), np.float32), np.zeros(2, np.float32),
             "features", "prediction").save(str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="not written by sparkdl_tpu_torch"):
        load_model(str(tmp_path / "jax"))


class Custom(LogisticRegression):
    """A stage class outside the package."""


def test_class_resolution_is_restricted(tmp_path):
    Custom(maxIter=3).save(str(tmp_path / "c"))
    with pytest.raises(ValueError, match="outside the trusted module"):
        load_model(str(tmp_path / "c"))
    back = load_model(str(tmp_path / "c"),
                      trusted_modules=Custom.__module__)
    assert type(back).__name__ == "Custom"
    assert back.getOrDefault("maxIter") == 3
    meta = json.loads((tmp_path / "c" / "metadata.json").read_text())
    meta["class"] = "os.path.join"
    (tmp_path / "c" / "metadata.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="outside the trusted module"):
        load_model(str(tmp_path / "c"))


def test_model_function_refuses_to_save(tmp_path):
    import torch

    from sparkdl_tpu_torch import TensorTransformer
    from sparkdl_tpu_torch.graph.function import ModelFunction
    mf = ModelFunction(torch.nn.Identity(), {"x": ((2,), np.float32)},
                       ["x"], device="cpu")
    tt = TensorTransformer(modelFunction=mf, inputMapping={"a": "x"},
                           outputMapping={"x": "b"})
    with pytest.raises(TypeError, match="param_modelFunction") as err:
        tt.save(str(tmp_path / "tt"))
    assert "torch.export" in str(err.value)
