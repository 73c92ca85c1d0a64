"""Save and load of the port's stages: a fitted ``LogisticRegressionModel``,
an unfitted ``Pipeline``, a fitted ``PipelineModel`` with the committed
TestNet featurizer, and a ``CrossValidatorModel``, each reloaded to the
same transform bits; a ``TensorTransformer`` / ``ImageTransformer``
holding a ``ModelFunction`` (saved as its ``torch.export`` program) and a
module-level ``imageLoader`` (saved as its import path), reloaded to the
same bits with no pickle written; and the refusals (overwrite, a
directory that is no saved stage, a class or callable outside the
trusted modules, a function that does not export, a lambda)."""

import json
import os

import numpy as np
import pytest
import torch

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


class _HostOnly(torch.nn.Module):
    """A module that leaves torch for numpy, which ``torch.export``
    cannot trace."""

    def forward(self, inputs):
        return {"x": torch.from_numpy(inputs["x"].numpy() * 2)}


def test_model_function_refuses_to_save(tmp_path):
    """A ModelFunction is saved as its ``torch.export`` program; one that
    does not export is refused with ``TypeError`` naming its key, and
    nothing of it is left to load."""
    from sparkdl_tpu_torch import TensorTransformer
    from sparkdl_tpu_torch.graph.function import ModelFunction
    mf = ModelFunction(_HostOnly(), {"x": ((2,), np.float32)},
                       ["x"], device="cpu")
    tt = TensorTransformer(modelFunction=mf, inputMapping={"a": "x"},
                           outputMapping={"x": "b"})
    with pytest.raises(TypeError, match="param_modelFunction") as err:
        tt.save(str(tmp_path / "tt"))
    assert "torch.export" in str(err.value)
    assert not (tmp_path / "tt" / "metadata.json").exists()


def _no_pickle(path):
    names = [os.path.join(d, f) for d, _, files in os.walk(path)
             for f in files]
    assert names and not [n for n in names
                          if n.endswith((".pkl", ".pickle"))], names
    return names


@pytest.mark.parametrize("fmt", ["rgb", "yuv420"])
def test_tensor_transformer_with_device_resize_model_round_trip(
        tmp_path, empty_caches, fmt):
    """A ``TensorTransformer`` holding ``deviceResizeModel(TestNet)`` saves
    its function as a ``torch.export`` program and reloads to the same
    bits, with no pickle written."""
    from sparkdl_tpu_torch import TensorTransformer
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    mf = deviceResizeModel(zoo.getModelFunction("TestNet", device="cpu"),
                           (40, 40), packedFormat=fmt)
    shape, _ = mf.input_signature["image"]
    x = np.random.default_rng(2).integers(0, 256, (10,) + shape,
                                          dtype=np.uint8)
    df = DataFrame.from_columns({"image": x}, 3)
    tt = TensorTransformer(modelFunction=mf, inputMapping={"image": "image"},
                           outputMapping={"features": "f"}, batchSize=4)
    tt.save(str(tmp_path / "tt"))
    names = _no_pickle(str(tmp_path / "tt"))
    assert any(n.endswith("param_modelFunction.pt2") for n in names)
    back = load_model(str(tmp_path / "tt"))
    got = back.getModelFunction()
    assert isinstance(got, ModelFunction) and got.name == mf.name
    assert got.device == mf.device and got.input_signature == {
        "image": (shape, np.dtype(np.uint8))}
    np.testing.assert_array_equal(back.transform(df).tensor("f"),
                                  tt.transform(df).tensor("f"))


def test_image_transformer_with_fixed_batch_program_round_trip(
        tmp_path, empty_caches):
    """A function that wraps a fixed-batch program saves at that batch
    and reloads with it."""
    from sparkdl_tpu_torch import ImageTransformer
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import zoo
    frozen = ModelFunction.deserialize(
        zoo.getModelFunction("TestNet", device="cpu").export(batch_size=4),
        device="cpu")
    df = _testnet_frame(n=12)
    it = ImageTransformer(inputCol="image", outputCol="f",
                          modelFunction=frozen.rename_io(
                              output_map={"features": "emb"}),
                          batchSize=4)
    it.save(str(tmp_path / "it"))
    _no_pickle(str(tmp_path / "it"))
    back = load_model(str(tmp_path / "it"))
    assert back.getModelFunction()._fixed_batch == 4
    assert back.getModelFunction().output_names == ["emb"]
    np.testing.assert_array_equal(back.transform(df).tensor("f"),
                                  it.transform(df).tensor("f"))


def image_loader(uri):
    """A module-level loader: saved by its import path."""
    return np.full((4, 4, 3), len(uri) % 7, np.float32)


def test_image_loader_saved_by_import_path(tmp_path):
    import keras
    from sparkdl_tpu_torch import KerasImageFileTransformer
    model = keras.Sequential([keras.layers.Input((4, 4, 3)),
                              keras.layers.Flatten(),
                              keras.layers.Dense(2)])
    mpath = str(tmp_path / "m.keras")
    model.save(mpath)
    t = KerasImageFileTransformer(inputCol="uri", outputCol="o",
                                  modelFile=mpath, imageLoader=image_loader,
                                  batchSize=2, device="cpu")
    t.save(str(tmp_path / "k"))
    _no_pickle(str(tmp_path / "k"))
    meta = json.loads((tmp_path / "k" / "metadata.json").read_text())
    assert meta["params"]["imageLoader"] == {
        "kind": "callable", "module": __name__, "qualname": "image_loader"}
    with pytest.raises(ValueError, match="outside the trusted module"):
        load_model(str(tmp_path / "k"))
    back = load_model(str(tmp_path / "k"), trusted_modules=[__name__])
    assert back.getImageLoader() is image_loader
    df = DataFrame.from_columns(
        {"uri": np.array(["a", "bb", "ccc"], dtype=object)}, 2)
    np.testing.assert_array_equal(back.transform(df).tensor("o"),
                                  t.transform(df).tensor("o"))


def test_lambda_refused_naming_its_key(tmp_path):
    from sparkdl_tpu_torch import KerasImageFileTransformer
    t = KerasImageFileTransformer(inputCol="uri", outputCol="o",
                                  modelFile="m.keras",
                                  imageLoader=lambda u: np.zeros(3))
    with pytest.raises(TypeError, match="param_imageLoader") as err:
        t.save(str(tmp_path / "k"))
    assert "lambda" in str(err.value)
