"""The port's UDF registry and ``registerKerasImageUDF`` against the JAX
package's (``tests/test_udf.py``), on the CPU: register, call through
the frame by name and directly, and compare with the JAX package's UDF
over the same images and the same Keras model. float32 on both sides,
differing by the order of float32 sums: ``TOL_F32`` of the reference's
largest magnitude."""

import numpy as np
import pytest
import torch

import sparkdl_tpu.udf as jax_udf
from sparkdl_tpu_torch.graph.function import ModelFunction
from sparkdl_tpu_torch.udf import (
    callUDF,
    getUDF,
    listUDFs,
    makeModelUDF,
    registerKerasImageUDF,
    unregisterUDF,
)

TOL_F32 = 1e-5


def assert_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL_F32 * max(1.0, np.abs(ref).max()))


@pytest.fixture(autouse=True)
def _clean_registries():
    yield
    for name in listUDFs():
        unregisterUDF(name)
    for name in jax_udf.listUDFs():
        jax_udf.unregisterUDF(name)


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image
    rng = np.random.default_rng(11)
    d = tmp_path_factory.mktemp("torch_udf_imgs")
    for i, (h, w) in enumerate([(16, 16), (24, 20), (10, 12)]):
        arr = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr, "RGB").save(d / f"u{i}.png")
    return str(d)


@pytest.fixture
def frames(image_dir):
    import sparkdl_tpu
    import sparkdl_tpu_torch
    return (sparkdl_tpu_torch.readImages(image_dir, numPartitions=2),
            sparkdl_tpu.readImages(image_dir, numPartitions=2))


class _Double(torch.nn.Module):
    def forward(self, x):
        return x.to(torch.float32) * 2.0


def _double_mf():
    return ModelFunction.fromSingle(_Double(), input_shape=(4,),
                                    input_dtype=np.float32, name="double",
                                    device="cpu")


def _jax_double_mf():
    from sparkdl_tpu.graph.function import ModelFunction as JaxMF
    return JaxMF.fromSingle(lambda x: x.astype("float32") * 2.0, None,
                            input_shape=(4,), input_dtype=np.float32,
                            name="double")


class TestRegistry:
    def test_register_get_call(self):
        import sparkdl_tpu
        import sparkdl_tpu_torch
        u = makeModelUDF(_double_mf(), "double", kind="tensor")
        assert "double" in listUDFs()
        assert getUDF("double") is u
        rows = [{"x": [1.0, 2.0, 3.0, 4.0]}, {"x": [0.0, 0.5, 1.0, 1.5]}]
        out = callUDF("double", sparkdl_tpu_torch.DataFrame.from_pylist(
            rows), "x", "y").tensor("y")
        jax_udf.makeModelUDF(_jax_double_mf(), "double", kind="tensor")
        ref = jax_udf.callUDF("double", sparkdl_tpu.DataFrame.from_pylist(
            rows), "x", "y").tensor("y")
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, [[2, 4, 6, 8], [0, 1, 2, 3]])

    def test_duplicate_rejected_unless_replace(self):
        makeModelUDF(_double_mf(), "dup")
        with pytest.raises(ValueError, match="already registered"):
            makeModelUDF(_double_mf(), "dup")
        makeModelUDF(_double_mf(), "dup", replace=True)

    def test_unknown_name(self):
        with pytest.raises(KeyError, match="no UDF named"):
            getUDF("nope")

    def test_unknown_kind(self):
        with pytest.raises(ValueError, match="kind must be"):
            makeModelUDF(_double_mf(), "k", kind="audio")

    def test_direct_call(self):
        u = makeModelUDF(_double_mf(), "d2", register=False)
        assert "d2" not in listUDFs()
        x = np.random.default_rng(0).normal(size=(5, 4)).astype(np.float32)
        ref = jax_udf.makeModelUDF(_jax_double_mf(), "d2",
                                   register=False)(x)
        np.testing.assert_array_equal(u(x), ref)
        np.testing.assert_array_equal(u({"input": x}), ref)

    def test_unregister(self):
        makeModelUDF(_double_mf(), "gone")
        assert unregisterUDF("gone")
        assert not unregisterUDF("gone")
        assert "gone" not in listUDFs()


@pytest.fixture(scope="module")
def keras_img_model():
    import keras
    keras.utils.set_random_seed(4)
    return keras.Sequential([
        keras.layers.Input((12, 12, 3)),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax"),
    ])


def _pre(x):
    """Scale to [0, 1] inside the model's program: the same expression
    on a torch tensor and a jax array."""
    return x / 255.0


class TestRegisterKerasImageUDF:
    def test_matches_jax_without_preprocessor(self, keras_img_model,
                                              frames):
        df, jax_df = frames
        u = registerKerasImageUDF("kudf", keras_img_model, device="cpu")
        assert u.kind == "image"
        assert u.model_fn.input_signature == {
            "image": ((12, 12, 3), np.uint8)}
        got = callUDF("kudf", df, "image", "probs").tensor("probs")
        jax_udf.registerKerasImageUDF("kudf", keras_img_model)
        ref = jax_udf.callUDF("kudf", jax_df, "image", "probs") \
            .tensor("probs")
        assert got.shape == ref.shape == (3, 5)
        assert_close(got, ref)

    def test_matches_jax_with_preprocessor(self, keras_img_model, frames):
        df, jax_df = frames
        registerKerasImageUDF("kpre", keras_img_model, preprocessor=_pre,
                              device="cpu")
        got = callUDF("kpre", df, "image", "p").tensor("p")
        jax_udf.registerKerasImageUDF("kpre", keras_img_model,
                                      preprocessor=_pre)
        ref = jax_udf.callUDF("kpre", jax_df, "image", "p").tensor("p")
        assert_close(got, ref)
        # the packed images through Keras itself
        from sparkdl_tpu_torch.transformers.utils import packImageBatch
        packed = packImageBatch(df.collect()["image"], 12, 12, 3)
        assert_close(got, np.asarray(keras_img_model(
            packed.astype(np.float32) / 255.0)))

    def test_input_size_with_preprocessor(self, keras_img_model, frames):
        """``input_size`` packs at another size; the preprocessor makes
        the model's input from it."""
        df, jax_df = frames

        def crop(x):
            return x[:, 2:14, 2:14, :] / 255.0

        u = registerKerasImageUDF("kcrop", keras_img_model,
                                  preprocessor=crop, input_size=(16, 16),
                                  device="cpu")
        assert u.model_fn.input_signature["image"][0] == (16, 16, 3)
        got = callUDF("kcrop", df, "image", "p").tensor("p")
        jax_udf.registerKerasImageUDF("kcrop", keras_img_model,
                                      preprocessor=crop, input_size=(16, 16))
        assert_close(got, jax_udf.callUDF("kcrop", jax_df, "image", "p")
                     .tensor("p"))

    def test_from_file(self, keras_img_model, frames, tmp_path):
        df, jax_df = frames
        path = str(tmp_path / "m.keras")
        keras_img_model.save(path)
        registerKerasImageUDF("kfile", path, device="cpu")
        got = callUDF("kfile", df, "image", "o").tensor("o")
        jax_udf.registerKerasImageUDF("kfile", path)
        ref = jax_udf.callUDF("kfile", jax_df, "image", "o").tensor("o")
        assert got.shape == (3, 5)
        assert_close(got, ref)

    def test_direct_call_on_packed_images(self, keras_img_model):
        u = registerKerasImageUDF("kdirect", keras_img_model,
                                  register=False, device="cpu")
        x = np.random.default_rng(5).integers(0, 256, (4, 12, 12, 3),
                                              dtype=np.uint8)
        assert_close(u(x), np.asarray(keras_img_model(
            x.astype(np.float32))))

    def test_non_image_model_rejected(self):
        import keras
        m = keras.Sequential([keras.layers.Input((7,)),
                              keras.layers.Dense(2)])
        with pytest.raises(ValueError, match="HWC"):
            registerKerasImageUDF("bad", m, device="cpu")
        assert "bad" not in listUDFs()

    def test_session_waits_for_spark_binding(self, keras_img_model):
        with pytest.raises(NotImplementedError, match="spark_binding"):
            registerKerasImageUDF("ksql", keras_img_model, session=object(),
                                  device="cpu")
