"""The port's Keras paths against the JAX package's, on the CPU: the Keras
converter (``graph/keras_convert.py``) layer kind by layer kind against
the JAX package's ``ModelIngest.fromKerasModel`` of the same model (which
runs it through Keras's JAX backend), its refusal of a layer it does not
know, ``KerasTransformer`` and ``KerasImageFileTransformer`` against the
JAX package's on the same model file and the same module-level
``imageLoader``, and ``import_keras_weights`` for the five
keras.applications architectures against Keras's own output, at the
sizes and bounds of ``tests/test_import_keras.py``.

Keras-origin paths run on the CPU only: the card's machine has no keras.
float32 on both sides, differing by the order of float32 sums:
``TOL_F32`` of the reference's largest magnitude.
"""

import os

import numpy as np
import pytest
import torch

# keras warns when predict() gets a bare array instead of its named
# input structure; noise in these comparisons
pytestmark = pytest.mark.filterwarnings(
    "ignore:The structure of `inputs` doesn't match")

TOL_F32 = 1e-5


def assert_close(got, ref, tol=TOL_F32):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _randomize(model, seed=0):
    """Seeded weights for every variable (BatchNorm variances kept
    positive), so no layer is an identity by its initializer."""
    rng = np.random.default_rng(seed)
    for v in model.weights:
        value = rng.normal(0, 0.5, tuple(v.shape)).astype(np.float32)
        if "variance" in v.path:
            value = np.abs(value) + 0.5
        v.assign(value)
    return model


def _model(kind):
    """A small model around one layer kind (``kind`` names the case)."""
    import keras
    L = keras.layers
    img = (9, 10, 3)
    cases = {
        "conv_same_stride2": (img, [L.Conv2D(4, 3, strides=2,
                                             padding="same",
                                             activation="relu")]),
        "conv_valid_dilated": (img, [L.Conv2D(3, 3, dilation_rate=2,
                                              use_bias=False)]),
        "separable_mult2": (img, [L.SeparableConv2D(5, 3, padding="same",
                                                    strides=2,
                                                    depth_multiplier=2)]),
        "depthwise": (img, [L.DepthwiseConv2D(3, depth_multiplier=2,
                                              padding="same")]),
        "dense_rank2": ((7,), [L.Dense(5, activation="sigmoid")]),
        "dense_rank4": (img, [L.Dense(4, use_bias=False)]),
        "batchnorm_eps": (img, [L.BatchNormalization(epsilon=0.05)]),
        "batchnorm_no_scale": ((6,), [L.BatchNormalization(
            scale=False, center=False)]),
        "activation_softmax": (img, [L.Activation("softmax")]),
        "activation_tanh": ((5,), [L.Activation("tanh")]),
        "relu_options": (img, [L.ReLU(max_value=0.6, negative_slope=0.2,
                                      threshold=0.1)]),
        "maxpool_same": (img, [L.MaxPooling2D(3, strides=2,
                                              padding="same")]),
        "maxpool_valid": (img, [L.MaxPooling2D(2)]),
        "avgpool_same": (img, [L.AveragePooling2D(3, strides=2,
                                                  padding="same")]),
        "avgpool_valid": (img, [L.AveragePooling2D(2)]),
        "global_avg": (img, [L.GlobalAveragePooling2D()]),
        "global_max_keepdims": (img, [L.GlobalMaxPooling2D(keepdims=True)]),
        "flatten_after_conv": (img, [L.Conv2D(2, 3), L.Flatten(),
                                     L.Dense(3)]),
        "dropout": ((6,), [L.Dropout(0.5), L.Dense(2)]),
        "zero_padding": (img, [L.ZeroPadding2D(((1, 0), (2, 3)))]),
        "rescaling": (img, [L.Rescaling(1 / 127.5, offset=-1.0)]),
        "reshape": ((12,), [L.Reshape((2, 2, 3)), L.Conv2D(2, 1),
                            L.Reshape((8,))]),
    }
    if kind == "add_concatenate":
        i = L.Input(img)
        a = L.Conv2D(4, 3, padding="same")(i)
        b = L.Conv2D(4, 1)(i)
        c = L.Concatenate()([a, L.Add()([a, b]), i])
        return keras.Model(i, L.GlobalAveragePooling2D()(c)), img
    shape, layers = cases[kind]
    return keras.Sequential([L.Input(shape)] + layers), shape


LAYER_CASES = [
    "conv_same_stride2", "conv_valid_dilated", "separable_mult2",
    "depthwise", "dense_rank2", "dense_rank4", "batchnorm_eps",
    "batchnorm_no_scale", "activation_softmax", "activation_tanh",
    "relu_options", "maxpool_same", "maxpool_valid", "avgpool_same",
    "avgpool_valid", "global_avg", "global_max_keepdims",
    "flatten_after_conv", "dropout", "zero_padding", "rescaling",
    "reshape", "add_concatenate"]


@pytest.mark.parametrize("kind", LAYER_CASES)
def test_converter_layer_matches_jax_ingest(kind):
    """Each converted layer kind (with its options: "same" padding with
    stride 2, a depth multiplier of 2, a BatchNormalization epsilon that
    is not the default, a Flatten after a conv, Add and Concatenate)
    gives the JAX package's ``fromKerasModel`` output on the same model,
    inputs and weights."""
    from sparkdl_tpu.graph import ModelIngest as JaxModelIngest
    from sparkdl_tpu_torch.graph import ModelIngest
    model, shape = _model(kind)
    _randomize(model, seed=len(kind))
    x = np.random.default_rng(3).normal(0, 1, (3,) + shape) \
        .astype(np.float32)
    mf = ModelIngest.fromKerasModel(model, device="cpu")
    ref = np.asarray(JaxModelIngest.fromKerasModel(model)(x))
    got = mf(x)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert_close(got, ref)


def test_converter_refuses_unknown_layer():
    import keras
    from sparkdl_tpu_torch.graph import ModelIngest
    model = keras.Sequential([keras.layers.Input((6, 4)),
                              keras.layers.Conv1D(2, 3)])
    with pytest.raises(NotImplementedError, match="Conv1D"):
        ModelIngest.fromKerasModel(model, device="cpu")
    model = keras.Sequential([keras.layers.Input((4,)),
                              keras.layers.Dense(2, activation="mish")])
    with pytest.raises(NotImplementedError, match="mish"):
        ModelIngest.fromKerasModel(model, device="cpu")


def test_converter_refuses_dynamic_input():
    import keras
    from sparkdl_tpu_torch.graph import ModelIngest
    model = keras.Sequential([keras.layers.Input((None, None, 3)),
                              keras.layers.GlobalAveragePooling2D()])
    with pytest.raises(ValueError, match="dynamic input shape"):
        ModelIngest.fromKerasModel(model, device="cpu")


def test_converted_model_exports(tmp_path):
    """A converted Keras model is a plain torch module: it exports and
    reloads with the same bits."""
    from sparkdl_tpu_torch.graph import ModelFunction, ModelIngest
    model, shape = _model("add_concatenate")
    _randomize(model, seed=5)
    mf = ModelIngest.fromKerasModel(model, device="cpu")
    back = ModelFunction.deserialize(mf.export(), device="cpu")
    x = np.random.default_rng(4).normal(0, 1, (2,) + shape) \
        .astype(np.float32)
    np.testing.assert_array_equal(back(x), mf(x))


# -- the Keras transformers ---------------------------------------------------

IMG_SIZE = 8


def image_loader(uri):
    """A module-level loader, as both packages' transformers take it:
    the image resized to the model's size, scaled to [0, 1]."""
    from PIL import Image
    img = Image.open(uri).convert("RGB").resize((IMG_SIZE, IMG_SIZE),
                                                Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    import keras
    from PIL import Image
    d = tmp_path_factory.mktemp("torch_keras")
    tensor_model = keras.Sequential([
        keras.layers.Input((6,)), keras.layers.Dense(5, activation="relu"),
        keras.layers.Dense(3)])
    _randomize(tensor_model, seed=1)
    tensor_path = str(d / "tensor.keras")
    tensor_model.save(tensor_path)
    image_model = keras.Sequential([
        keras.layers.Input((IMG_SIZE, IMG_SIZE, 3)),
        keras.layers.Conv2D(4, 3, activation="relu", padding="same"),
        keras.layers.BatchNormalization(),
        keras.layers.MaxPooling2D(2),
        keras.layers.Flatten(),
        keras.layers.Dense(5, activation="softmax")])
    _randomize(image_model, seed=2)
    image_path = str(d / "image.h5")
    image_model.save(image_path)
    rng = np.random.default_rng(8)
    uris = []
    for i in range(7):
        arr = rng.integers(0, 256, (10 + i, 12, 3), dtype=np.uint8)
        p = d / f"k{i}.png"
        Image.fromarray(arr, "RGB").save(p)
        uris.append(str(p))
    return tensor_path, image_path, uris


def test_keras_transformer_matches_jax(keras_files):
    import pyarrow as pa
    import sparkdl_tpu
    import sparkdl_tpu_torch
    tensor_path, _, _ = keras_files
    x = np.random.default_rng(9).normal(0, 1, (10, 6)).astype(np.float32)
    kw = dict(inputCol="x", outputCol="y", modelFile=tensor_path,
              batchSize=4)
    ref = sparkdl_tpu.KerasTransformer(**kw).transform(
        sparkdl_tpu.DataFrame.from_table(
            pa.table({"x": list(x)}), 3)).tensor("y")
    t = sparkdl_tpu_torch.KerasTransformer(device="cpu", **kw)
    got = t.transform(sparkdl_tpu_torch.DataFrame.from_columns(
        {"x": x}, 3)).tensor("y")
    assert got.shape == ref.shape == (10, 3)
    assert_close(got, ref)
    assert t.metrics.rows == 10


@pytest.mark.parametrize("mode", ["vector", "image"])
def test_keras_image_file_transformer_matches_jax(keras_files, mode):
    import pyarrow as pa
    import sparkdl_tpu
    import sparkdl_tpu_torch
    _, image_path, uris = keras_files
    kw = dict(inputCol="uri", outputCol="p", modelFile=image_path,
              imageLoader=image_loader, batchSize=4)
    if mode == "vector":
        ref = sparkdl_tpu.KerasImageFileTransformer(**kw).transform(
            sparkdl_tpu.DataFrame.from_table(pa.table({"uri": uris}), 2)
        ).tensor("p")
        got = sparkdl_tpu_torch.KerasImageFileTransformer(
            device="cpu", **kw).transform(
            sparkdl_tpu_torch.DataFrame.from_columns(
                {"uri": np.array(uris, dtype=object)}, 2)).tensor("p")
        assert got.shape == ref.shape == (7, 5)
        assert_close(got, ref)
        return
    # outputMode="image" needs an [N, H, W, C] output: the conv trunk
    import keras
    trunk = keras.Sequential([keras.layers.Input((IMG_SIZE, IMG_SIZE, 3)),
                              keras.layers.Conv2D(3, 3, padding="same"),
                              keras.layers.Rescaling(60.0, offset=100.0)])
    _randomize(trunk, seed=3)
    path = image_path.replace("image.h5", "trunk.keras")
    trunk.save(path)
    kw.update(modelFile=path, outputMode="image")
    out = sparkdl_tpu_torch.KerasImageFileTransformer(
        device="cpu", **kw).transform(
        sparkdl_tpu_torch.DataFrame.from_columns(
            {"uri": np.array(uris, dtype=object)}, 2)).collect()["p"]
    ref = sparkdl_tpu.KerasImageFileTransformer(**kw).transform(
        sparkdl_tpu.DataFrame.from_table(pa.table({"uri": uris}), 2)
    ).collect().column("p").to_pylist()
    for got_row, ref_row in zip(out, ref):
        assert (got_row["height"], got_row["width"],
                got_row["nChannels"]) == (ref_row["height"],
                                          ref_row["width"], 3)
        a = np.frombuffer(got_row["data"], np.uint8).astype(int)
        b = np.frombuffer(ref_row["data"], np.uint8).astype(int)
        # rounded to uint8: a float32 sum at a .5 tie may round either way
        assert np.abs(a - b).max() <= 1


def test_keras_image_file_transformer_names_loader_mistakes(keras_files):
    import sparkdl_tpu_torch
    _, image_path, uris = keras_files
    df = sparkdl_tpu_torch.DataFrame.from_columns(
        {"uri": np.array(uris[:2], dtype=object)}, 1)
    wrong = sparkdl_tpu_torch.KerasImageFileTransformer(
        inputCol="uri", outputCol="o", modelFile=image_path,
        imageLoader=lambda u: np.zeros((5, 5, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="imageLoader.*expects"):
        wrong.transform(df).collect()


# -- import_keras_weights against Keras ---------------------------------------

def _oracle(name, keras_ctor, size, tol, feat_layer, feat_tol):
    """Convert a keras.applications model built once with seeded weights,
    and hold the port's float32 network to Keras's output: softmax
    probabilities and the featurize layer."""
    import keras
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.models.import_keras import import_keras_weights
    keras.utils.set_random_seed(7)
    kmodel = keras_ctor(weights=None)
    spec = zoo.getKerasApplicationModel(name)
    state = import_keras_weights(spec.module_fn, kmodel, (size, size, 3))
    net = zoo.build_module(spec.module_fn, state, torch.device("cpu"),
                           dtype=torch.float32)
    x = np.random.default_rng(1).normal(0, 1, (2, size, size, 3)) \
        .astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.inference_mode():
        ours = torch.softmax(net(xt), dim=-1).numpy()
        feats_ours = net(xt, features_only=True).numpy()
    theirs = np.asarray(kmodel(x))
    diff = float(np.abs(ours - theirs).max())
    assert diff <= tol, f"{name}: max prob diff {diff} > {tol}"
    feats_theirs = np.asarray(keras.Model(
        kmodel.inputs, kmodel.get_layer(feat_layer).output)(x))
    assert feats_ours.shape == feats_theirs.shape
    scale = max(1.0, float(np.abs(feats_theirs).max()))
    fdiff = float(np.abs(feats_ours - feats_theirs).max()) / scale
    assert fdiff <= feat_tol, \
        f"{name}: featurize relative diff {fdiff} > {feat_tol}"


@pytest.mark.parametrize("name,module,ctor,size,tol,feat,feat_tol", [
    ("InceptionV3", "inception_v3", "InceptionV3", 299, 1e-4, "avg_pool",
     1e-4),
    ("VGG16", "vgg16", "VGG16", 224, 1e-5, "fc2", 1e-5),
    ("VGG19", "vgg19", "VGG19", 224, 1e-5, "fc2", 1e-5),
    ("ResNet50", "resnet50", "ResNet50", 224, 1e-5, "avg_pool", 1e-5),
    ("Xception", "xception", "Xception", 299, 1e-4, "avg_pool", 1e-4)])
def test_import_keras_weights_oracle(name, module, ctor, size, tol, feat,
                                     feat_tol):
    import importlib
    mod = importlib.import_module(f"keras.applications.{module}")
    _oracle(name, getattr(mod, ctor), size, tol, feat, feat_tol)


def test_import_named_model_feeds_zoo_cache(tmp_path, monkeypatch):
    """Converted weights land in the port's cache as ``VGG16.pt`` and
    ``zoo.getModelFunction`` serves them; a count mismatch (VGG16's
    weights into TestNet) fails loudly."""
    import keras
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher
    from sparkdl_tpu_torch.models.import_keras import (
        import_keras_weights,
        import_named_model,
    )
    from sparkdl_tpu_torch.models.testnet import TestNet
    monkeypatch.setenv("SPARKDL_TPU_TORCH_MODEL_CACHE", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    keras.utils.set_random_seed(3)
    kmodel = keras.applications.vgg16.VGG16(weights=None)
    fetcher = ModelFetcher()
    import_named_model("VGG16", keras_model=kmodel, fetcher=fetcher)
    assert fetcher.has("VGG16.pt")
    assert zoo.weights_provenance("VGG16", fetcher) == "cache"

    mf = zoo.getModelFunction("VGG16", featurize=False, fetcher=fetcher,
                              device="cpu")
    x = np.random.default_rng(2).integers(0, 255, (1, 224, 224, 3),
                                          dtype=np.uint8)
    ours = mf({"image": x})["predictions"]
    # Keras on the same caffe-preprocessed input; the zoo model runs in
    # bf16, as the JAX package's test holds it
    pre = x.astype(np.float32)[..., ::-1] - np.array(
        [103.939, 116.779, 123.68], np.float32)
    np.testing.assert_allclose(ours, np.asarray(kmodel(pre)), atol=1e-3)

    with pytest.raises(ValueError, match="count mismatch"):
        import_keras_weights(TestNet, kmodel, (32, 32, 3))


def test_class_index_is_copied_from_keras_cache_never_fetched(
        tmp_path, monkeypatch):
    import json
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher
    from sparkdl_tpu_torch.models.import_keras import (
        materialize_imagenet_class_index,
    )
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    fetcher = ModelFetcher(str(tmp_path / "cache"))
    assert materialize_imagenet_class_index(fetcher) is None
    src = tmp_path / "home" / ".keras" / "models"
    os.makedirs(src)
    index = {str(i): [f"n{i:08d}", f"name_{i}"] for i in range(1000)}
    (src / "imagenet_class_index.json").write_text(json.dumps(index))
    dst = materialize_imagenet_class_index(fetcher)
    with open(dst) as f:
        assert json.load(f) == index
