"""The port's models (``sparkdl_tpu_torch.models``) against the JAX
package's flax models on the CPU, through the weight bridge
(``models/convert.py``); the port's msgpack reader, committed artifact,
weight cascade, zoo registry and ``decode_predictions`` against the JAX
package's.

The JAX side takes its variables from ``jax.eval_shape(module.init, ...)``
filled from numpy — BatchNorm statistics random, not the seeded init's
mean 0 / var 1, which would hide a BatchNorm bug — and runs un-jitted.
Each comparison states its tolerance:

* float32: ``TOL_F32`` of the reference's largest magnitude — the two
  sides differ only in the order of float32 sums.
* bfloat16: two rounding steps (``TOL_BF16_LAYER``) for one layer or
  block and four (``TOL_BF16_NET``) for a whole network (InceptionV3,
  ResNet50, Xception, VGG16/19), as max|diff| over the reference's
  largest magnitude. bf16 keeps 8 significant bits (a step is 2^-8 ≈
  3.9e-3 relative); where the two sides' fp32 accumulations land on
  either side of a rounding boundary the result differs by a step, and
  a deep net carries such flips forward.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sparkdl_tpu.models import inception as jax_inception
from sparkdl_tpu.models import layers as jax_layers
from sparkdl_tpu.models import resnet as jax_resnet
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu.models import vgg as jax_vgg
from sparkdl_tpu.models import xception as jax_xception
from sparkdl_tpu_torch.models import (
    inception,
    layers,
    resnet,
    testnet,
    vgg,
    xception,
)
from sparkdl_tpu_torch.models.convert import flax_to_state_dict

TOL_F32 = 1e-5
BF16_STEP = 2.0 ** -8
TOL_BF16_LAYER = 2 * BF16_STEP
TOL_BF16_NET = 4 * BF16_STEP

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def random_variables(module, x, seed=0):
    """The module's variables tree (shapes from ``jax.eval_shape``, no
    compile) filled from numpy: LeCun-normal kernels, random BatchNorm
    scale/bias/mean/var."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, np.sqrt(1 / fan_in), s.shape)
        if name == "scale":
            return rng.uniform(0.5, 1.5, s.shape)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape)
        return rng.normal(0, 0.2, s.shape)   # bias, mean

    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(fill(p, s), np.float32), shapes)


def nchw(x_nhwc, dtype):
    return torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def assert_close(got, ref, tol):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, (err, scale, tol)


def run_pair(jax_module, torch_module, x, dtype_name, seed=0):
    """Run a flax module and its port on NHWC ``x`` with the same
    variables; returns (port output NHWC, reference NHWC)."""
    jdt, tdt = DTYPES[dtype_name]
    xj = jnp.asarray(x, jdt)
    variables = random_variables(jax_module, xj, seed)
    ref = np.asarray(jax_module.apply(variables, xj), np.float32)
    torch_module.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = nhwc(torch_module.eval()(nchw(x, tdt)))
    return got, ref


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(
        np.float32)


TOLS = {"f32": TOL_F32, "bf16": TOL_BF16_LAYER}

# (id, flax kwargs, input shape): the conv geometries the slice uses,
# TestNet's asymmetric stride-2 SAME conv among them
CONV_CASES = [
    ("3x3_same", dict(features=8, kernel=(3, 3)), (2, 7, 7, 5)),
    ("3x3_s2_valid", dict(features=8, kernel=(3, 3), strides=(2, 2),
                          padding="VALID"), (2, 9, 9, 5)),
    ("1x7_same", dict(features=6, kernel=(1, 7)), (1, 7, 9, 4)),
    ("3x3_s2_same_asym", dict(features=8, kernel=(3, 3), strides=(2, 2)),
     (2, 8, 8, 3)),
    ("1x1_no_relu", dict(features=4, kernel=(1, 1), relu=False),
     (1, 5, 5, 6)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_convbn(case, dtype):
    _, kw, shape = case
    jdt, tdt = DTYPES[dtype]
    jm = jax_layers.ConvBN(dtype=jdt, **kw)
    tm = layers.ConvBN(shape[-1], kw["features"], kw["kernel"],
                       strides=kw.get("strides", (1, 1)),
                       padding=kw.get("padding", "SAME"),
                       relu=kw.get("relu", True), dtype=tdt)
    got, ref = run_pair(jm, tm, _x(shape), dtype)
    assert_close(got, ref, TOLS[dtype])


POOL_CASES = [
    ("max_3x3_s2_valid", jax_layers.max_pool, layers.max_pool,
     dict(window=(3, 3), strides=(2, 2), padding="VALID"), (2, 9, 9, 4)),
    ("max_2x2_s2_same_odd", jax_layers.max_pool, layers.max_pool,
     dict(window=(2, 2), strides=(2, 2), padding="SAME"), (2, 9, 7, 4)),
    ("avg_3x3_same", jax_layers.avg_pool, layers.avg_pool,
     dict(window=(3, 3), strides=(1, 1), padding="SAME"), (2, 7, 7, 4)),
    ("avg_2x2_s2_same_odd", jax_layers.avg_pool, layers.avg_pool,
     dict(window=(2, 2), strides=(2, 2), padding="SAME"), (2, 9, 7, 4)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", POOL_CASES, ids=[c[0] for c in POOL_CASES])
def test_pooling(case, dtype):
    _, jax_fn, torch_fn, kw, shape = case
    jdt, tdt = DTYPES[dtype]
    x = _x(shape)
    ref = np.asarray(jax_fn(jnp.asarray(x, jdt), **kw), np.float32)
    got = nhwc(torch_fn(nchw(x, tdt), **kw))
    assert_close(got, ref, TOLS[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_global_avg_pool(dtype):
    jdt, tdt = DTYPES[dtype]
    x = _x((2, 5, 6, 8))
    ref = np.asarray(jax_layers.global_avg_pool(jnp.asarray(x, jdt)),
                     np.float32)
    got = layers.global_avg_pool(nchw(x, tdt)).float().numpy()
    assert_close(got, ref, TOLS[dtype])


# (id, flax block, port block, input shape): ~5-9 px, narrow channels
BLOCK_CASES = [
    ("A", lambda d: jax_inception.InceptionBlockA(8, dtype=d),
     lambda c, d: inception.InceptionBlockA(c, 8, dtype=d), (1, 7, 7, 16)),
    ("RedA", lambda d: jax_inception.ReductionA(dtype=d),
     lambda c, d: inception.ReductionA(c, dtype=d), (1, 9, 9, 16)),
    ("B", lambda d: jax_inception.InceptionBlockB(12, dtype=d),
     lambda c, d: inception.InceptionBlockB(c, 12, dtype=d), (1, 7, 7, 16)),
    ("RedB", lambda d: jax_inception.ReductionB(dtype=d),
     lambda c, d: inception.ReductionB(c, dtype=d), (1, 9, 9, 16)),
    ("C", lambda d: jax_inception.InceptionBlockC(dtype=d),
     lambda c, d: inception.InceptionBlockC(c, dtype=d), (1, 5, 5, 16)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_inception_block(case, dtype):
    _, make_jax, make_torch, shape = case
    jdt, tdt = DTYPES[dtype]
    got, ref = run_pair(make_jax(jdt), make_torch(shape[-1], tdt),
                        _x(shape), dtype)
    assert_close(got, ref, TOLS[dtype])


def test_block_out_features_match_flax():
    for _, make_jax, make_torch, shape in BLOCK_CASES:
        jm, tm = make_jax(jnp.float32), make_torch(shape[-1], torch.float32)
        out = jax.eval_shape(lambda x: jm.init_with_output(
            jax.random.PRNGKey(0), x)[0], jnp.zeros(shape))
        assert out.shape[-1] == tm.out_features


@pytest.fixture(scope="module")
def testnet_variables(tmp_path_factory):
    """The committed TestNet weights (the JAX fetcher cache pointed at an
    empty directory, so the committed artifact is what loads)."""
    from sparkdl_tpu.models import zoo
    from sparkdl_tpu.models.fetcher import ModelFetcher
    empty = ModelFetcher(str(tmp_path_factory.mktemp("jax_cache")))
    assert zoo.weights_provenance("TestNet", empty) == "committed"
    return zoo.load_variables("TestNet", empty)


@pytest.mark.parametrize("features_only", [True, False])
def test_testnet_committed_weights(testnet_variables, features_only):
    x = np.random.default_rng(3).random((4, 32, 32, 3), np.float32)
    ref = np.asarray(jax_testnet.TestNet().apply(
        testnet_variables, jnp.asarray(x), features_only=features_only))
    tm = testnet.TestNet().eval()
    tm.load_state_dict(flax_to_state_dict(testnet_variables), strict=True)
    with torch.inference_mode():
        got = tm(nchw(x, torch.float32),
                 features_only=features_only).numpy()
    assert_close(got, ref, TOL_F32)


def test_inception_v3_whole_net_bf16():
    """The whole InceptionV3 at its smallest input (75×75), batch 1, in
    the model's own bf16; the JAX side un-jitted."""
    x = np.random.default_rng(4).uniform(-1, 1, (1, 75, 75, 3)).astype(
        np.float32)
    jm = jax_inception.InceptionV3()
    variables = random_variables(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x),
                              features_only=True))
    tm = inception.InceptionV3().eval()
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = tm(nchw(x, torch.float32), features_only=True).numpy()
    assert got.shape == (1, 2048) and got.dtype == np.float32
    assert_close(got, ref, TOL_BF16_NET)


@pytest.mark.parametrize("featurize", [True, False])
def test_zoo_model_function_matches_jax(testnet_variables, tmp_path,
                                        featurize):
    """``zoo.getModelFunction`` end to end (uint8 NHWC in, preprocess,
    features or softmax predictions out) against the JAX zoo's, with the
    committed TestNet weights seeded into the port's cache."""
    from sparkdl_tpu.models import zoo as jax_zoo
    from sparkdl_tpu.models.fetcher import ModelFetcher as JaxFetcher
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher
    fetcher = ModelFetcher(str(tmp_path))
    fetcher.put("TestNet.pt", flax_to_state_dict(testnet_variables))
    assert zoo.weights_provenance("TestNet", fetcher) == "cache"
    x = np.random.default_rng(5).integers(0, 256, (3, 32, 32, 3),
                                          dtype=np.uint8)
    jmf = jax_zoo.getModelFunction(
        "TestNet", featurize=featurize,
        fetcher=JaxFetcher(str(tmp_path / "jax_empty")))
    name = jmf.output_names[0]
    ref = np.asarray(jmf.apply_fn(jmf.params, {"image": x})[name])
    mf = zoo.getModelFunction("TestNet", featurize=featurize, device="cpu",
                              fetcher=fetcher)
    assert mf.output_names == [name]
    got = mf({"image": x})[name]
    assert_close(got, ref, TOL_F32)


# ---------------------------------------------------------------------------
# The rest of the zoo: ResNet50, Xception, VGG16/19, and their units
# ---------------------------------------------------------------------------

# (id, flax layer, port layer, input shape): ResNet's biased convs (its
# BatchNorm epsilon, a stride-2 1×1, the stem's explicit pads) and
# Xception's separable unit (with and without its ReLU, an odd size)
UNIT_CASES = [
    ("biased_3x3", lambda d: jax_layers.ConvBN(
        8, bn_epsilon=1.001e-5, use_bias=True, dtype=d),
     lambda c, d: layers.ConvBN(c, 8, bn_epsilon=1.001e-5, use_bias=True,
                                dtype=d), (2, 7, 7, 5)),
    ("biased_1x1_s2_no_relu", lambda d: jax_layers.ConvBN(
        6, (1, 1), strides=(2, 2), relu=False, bn_epsilon=1.001e-5,
        use_bias=True, dtype=d),
     lambda c, d: layers.ConvBN(c, 6, (1, 1), strides=(2, 2), relu=False,
                                bn_epsilon=1.001e-5, use_bias=True,
                                dtype=d), (1, 9, 8, 4)),
    ("biased_7x7_s2_pads", lambda d: jax_layers.ConvBN(
        8, (7, 7), strides=(2, 2), padding=[(3, 3), (3, 3)],
        bn_epsilon=1.001e-5, use_bias=True, dtype=d),
     lambda c, d: layers.ConvBN(c, 8, (7, 7), strides=(2, 2),
                                padding=[(3, 3), (3, 3)],
                                bn_epsilon=1.001e-5, use_bias=True,
                                dtype=d), (1, 16, 16, 3)),
    ("separable", lambda d: jax_layers.SeparableConvBN(12, dtype=d),
     lambda c, d: layers.SeparableConvBN(c, 12, dtype=d), (2, 7, 7, 8)),
    ("separable_no_relu_odd", lambda d: jax_layers.SeparableConvBN(
        5, relu=False, dtype=d),
     lambda c, d: layers.SeparableConvBN(c, 5, relu=False, dtype=d),
     (1, 9, 6, 6)),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", UNIT_CASES, ids=[c[0] for c in UNIT_CASES])
def test_biased_and_separable_units(case, dtype):
    _, make_jax, make_torch, shape = case
    jdt, tdt = DTYPES[dtype]
    got, ref = run_pair(make_jax(jdt), make_torch(shape[-1], tdt),
                        _x(shape), dtype)
    assert_close(got, ref, TOLS[dtype])


def test_bridge_depthwise_and_head_names():
    """A depthwise kernel HWIO ``(kh, kw, 1, C)`` lands as ``(C, 1, kh,
    kw)`` under ``depthwise``, the pointwise under ``pointwise``; a single
    ``Dense_0`` is ``fc`` while VGG's ``Conv_k``/``Dense_k`` keep their
    names."""
    rng = np.random.default_rng(12)
    dw = rng.normal(size=(3, 3, 1, 6)).astype(np.float32)
    pw = rng.normal(size=(1, 1, 6, 4)).astype(np.float32)
    ones = np.ones(4, np.float32)
    variables = {
        "params": {
            "SeparableConvBN_0": {"Conv_0": {"kernel": dw},
                                  "Conv_1": {"kernel": pw},
                                  "BatchNorm_0": {"scale": ones,
                                                  "bias": ones}},
            "Conv_0": {"kernel": pw, "bias": ones},
            "Dense_0": {"kernel": np.zeros((4, 3), np.float32),
                        "bias": np.zeros(3, np.float32)},
            "Dense_1": {"kernel": np.zeros((3, 2), np.float32),
                        "bias": np.zeros(2, np.float32)},
            "Block_0": {"Dense_0": {"kernel": np.zeros((4, 3), np.float32),
                                    "bias": np.zeros(3, np.float32)}},
        },
        "batch_stats": {"SeparableConvBN_0": {"BatchNorm_0": {
            "mean": ones, "var": ones}}},
    }
    sd = flax_to_state_dict(variables)
    assert sorted(sd) == sorted([
        "SeparableConvBN_0.depthwise.weight",
        "SeparableConvBN_0.pointwise.weight",
        "SeparableConvBN_0.bn.weight", "SeparableConvBN_0.bn.bias",
        "SeparableConvBN_0.bn.running_mean",
        "SeparableConvBN_0.bn.running_var",
        "Conv_0.weight", "Conv_0.bias", "Dense_0.weight", "Dense_0.bias",
        "Dense_1.weight", "Dense_1.bias", "Block_0.fc.weight",
        "Block_0.fc.bias"])
    got = sd["SeparableConvBN_0.depthwise.weight"].numpy()
    assert got.shape == (6, 1, 3, 3)
    for c in range(6):
        np.testing.assert_array_equal(got[c, 0], dw[:, :, 0, c])
    assert tuple(sd["SeparableConvBN_0.pointwise.weight"].shape) == \
        (4, 6, 1, 1)
    assert tuple(sd["Dense_0.weight"].shape) == (3, 4)
    # a depthwise conv with groups=C takes the bridged weight as it is
    sep = layers.SeparableConvBN(6, 4, dtype=torch.float32)
    sep.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()
                         if k.startswith("SeparableConvBN_0.")},
                        strict=True)


def _flax_blob_variables(variables):
    """``variables`` through flax's serializer and the port's reader, with
    the reader held to the msgpack library (flax's own restore) on the
    same blob; returns the port's tree and the blob."""
    from flax import serialization

    from sparkdl_tpu_torch.models import msgpack
    blob = serialization.to_bytes(variables)
    got = msgpack.loads(blob)
    ref = serialization.msgpack_restore(blob)

    def same(a, b):
        if isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b)
            for k in b:
                same(a[k], b[k])
        else:
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    same(got, ref)
    return got, blob


# (name, flax model, port model, input size): each at its smallest size
# that keeps what could go wrong visible — VGG at 64×64 ends on a 2×2×512
# map, so a flatten in the wrong order shows (at 32×32 the map is 1×1);
# ResNet50's final map is 2×2, so its global pool averages
NET_CASES = [
    ("ResNet50", jax_resnet.ResNet50, resnet.ResNet50, 64),
    ("Xception", jax_xception.Xception, xception.Xception, 71),
    ("VGG16", jax_vgg.VGG16,
     lambda: vgg.VGG16(input_size=(64, 64)), 64),
    ("VGG19", jax_vgg.VGG19,
     lambda: vgg.VGG19(input_size=(64, 64)), 64),
]


@pytest.mark.parametrize("case", NET_CASES, ids=[c[0] for c in NET_CASES])
def test_zoo_whole_net_bf16(case):
    """Each new zoo network whole, batch 1, in the model's own bf16,
    features and logits, against the flax model un-jitted on the same
    random variables (``TOL_BF16_NET``, as InceptionV3). VGG's variables
    go through ``flax.serialization.to_bytes`` and the port's msgpack
    reader (its 32 MB ``Dense_0`` kernel takes msgpack's ext32 route);
    the others through the bridge directly."""
    name, make_jax, make_torch, size = case
    x = np.random.default_rng(4).uniform(-1, 1, (1, size, size, 3)).astype(
        np.float32)
    jm = make_jax()
    variables = random_variables(jm, jnp.asarray(x))
    ref = np.asarray(jm.apply(variables, jnp.asarray(x),
                              features_only=True))
    ref_logits = np.asarray(jm.apply(variables, jnp.asarray(x)))
    if name.startswith("VGG"):
        variables, _ = _flax_blob_variables(variables)
        # an extension payload above 64 KiB is written as ext32
        assert variables["params"]["Dense_0"]["kernel"].nbytes > 0xffff
    tm = make_torch().eval()
    tm.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.inference_mode():
        got = tm(nchw(x, torch.float32), features_only=True).numpy()
        got_logits = tm(nchw(x, torch.float32)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert got.shape == (1, 4096 if name.startswith("VGG") else 2048)
    assert_close(got, ref, TOL_BF16_NET)
    assert got_logits.shape == (1, 1000)
    assert_close(got_logits, ref_logits, TOL_BF16_NET)


# ---------------------------------------------------------------------------
# Weights: the msgpack reader, the committed artifact, the cascade
# ---------------------------------------------------------------------------

ARTIFACTS = ("TestNet.msgpack", "TestNet.msgpack.sha256",
             "TestNet.class_index.json", "TestNet.provenance.json")


@pytest.mark.parametrize("fileName", ARTIFACTS)
def test_artifact_copies_are_byte_equal(fileName):
    from sparkdl_tpu.models import zoo as jax_zoo
    from sparkdl_tpu_torch.models import zoo
    with open(os.path.join(jax_zoo.ARTIFACTS_DIR, fileName), "rb") as f:
        ref = f.read()
    with open(os.path.join(zoo.ARTIFACTS_DIR, fileName), "rb") as f:
        assert f.read() == ref


def test_msgpack_reader_on_committed_blob(testnet_variables):
    """The committed blob through the port's reader: the msgpack
    library's tree array for array, and, through the bridge, the JAX
    package's loaded TestNet variables."""
    from sparkdl_tpu_torch.models import zoo
    with open(os.path.join(zoo.ARTIFACTS_DIR, "TestNet.msgpack"),
              "rb") as f:
        blob = f.read()
    assert blob.startswith(b"\x82\xa6params")
    got, _ = _flax_blob_variables(testnet_variables)
    from sparkdl_tpu_torch.models import msgpack
    tree = msgpack.loads(blob)
    sd, ref = flax_to_state_dict(tree), flax_to_state_dict(got)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)


@pytest.mark.parametrize("blob,where", [
    (b"\xc1", "0xc1 at offset 0"),
    (b"\x81\xa1a\xc3", "0xc3 at offset 3"),   # flax's chunked form
    (b"\x81\xa1a\xc7\x03\x02abc", "extension type 2 at offset 3"),
    (b"\x81\xa1a\xc7\x10\x01\x93\x91\x01", "needs 16 bytes"),
    (b"\x91\x01\x02", "1 bytes left over"),
    (b"\xd5\x01\x93\x90\xa7float32\xc4\x00", "not (shape, dtype, bytes)"),
])
def test_msgpack_reader_raises_with_the_offset(blob, where):
    from sparkdl_tpu_torch.models import msgpack
    with pytest.raises(ValueError) as err:
        msgpack.loads(blob)
    assert where in str(err.value)


def test_weights_cascade_order(tmp_path, testnet_variables):
    """The cache's ``.pt``, then its ``.msgpack`` (a JAX package cache
    entry, hash-checked), then the committed artifact, then the seeded
    init — what ``weights_provenance`` reports is what loads."""
    from sparkdl_tpu.models.fetcher import ModelFetcher as JaxFetcher
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher
    fetcher = ModelFetcher(str(tmp_path))
    committed = zoo.load_state_dict("TestNet", fetcher)
    assert zoo.weights_provenance("TestNet", fetcher) == "committed"
    ref = flax_to_state_dict(testnet_variables)
    for k in ref:
        torch.testing.assert_close(committed[k], ref[k], rtol=0, atol=0)
    assert zoo.weights_provenance("VGG19", fetcher) == "random"

    # a JAX cache entry: other weights, written by the JAX fetcher
    other = jax.tree_util.tree_map(lambda v: np.asarray(v) * 2,
                                   testnet_variables)
    JaxFetcher(str(tmp_path)).put("TestNet.msgpack", other)
    assert zoo.weights_provenance("TestNet", fetcher) == "cache"
    cached = zoo.load_state_dict("TestNet", fetcher)
    for k in ref:
        torch.testing.assert_close(cached[k], ref[k] * 2, rtol=0, atol=0)

    fetcher.put("TestNet.pt", {k: v * 3 for k, v in ref.items()})
    assert zoo.weights_provenance("TestNet", fetcher) == "cache"
    pt = zoo.load_state_dict("TestNet", fetcher)
    for k in ref:
        torch.testing.assert_close(pt[k], ref[k] * 3, rtol=0, atol=0)

    # a corrupt msgpack entry fails its hash check loudly
    os.remove(tmp_path / "TestNet.pt")
    with open(tmp_path / "TestNet.msgpack", "r+b") as f:
        f.seek(100)
        f.write(b"\x00")
    with pytest.raises(IOError, match="hash mismatch"):
        zoo.load_state_dict("TestNet", fetcher)


def test_committed_artifact_is_hash_checked(tmp_path, monkeypatch):
    """The committed blob loads through its sha256 sidecar: a flipped
    byte in a copy of the artifacts directory raises."""
    import shutil

    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher
    copy = tmp_path / "artifacts"
    shutil.copytree(zoo.ARTIFACTS_DIR, copy)
    monkeypatch.setattr(zoo, "ARTIFACTS_DIR", str(copy))
    empty = ModelFetcher(str(tmp_path / "cache"))
    assert zoo.weights_provenance("TestNet", empty) == "committed"
    zoo.load_state_dict("TestNet", empty)
    with open(copy / "TestNet.msgpack", "r+b") as f:
        f.seek(200)
        byte = f.read(1)
        f.seek(200)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(IOError, match="hash mismatch"):
        zoo.load_state_dict("TestNet", empty)


@pytest.mark.parametrize("top", [1, 3, 5])
@pytest.mark.parametrize("index", ["imagenet", "testnet"])
def test_decode_predictions_matches_jax(top, index):
    """The same array through both packages' ``decode_predictions``, with
    the synthetic ImageNet names and with TestNet's class index; ties
    included (equal scores keep the same order)."""
    from sparkdl_tpu.models import zoo as jax_zoo
    from sparkdl_tpu_torch.models import zoo
    n_classes = 1000 if index == "imagenet" else 10
    rng = np.random.default_rng(13)
    probs = rng.random((6, n_classes)).astype(np.float32)
    probs[2, 3] = probs[2, 7] = probs[2].max() + 0.5   # a tie at the top
    jax_index = torch_index = None
    if index == "testnet":
        jax_index = jax_zoo.model_class_index("TestNet")
        torch_index = zoo.model_class_index("TestNet")
        assert torch_index == jax_index and torch_index[3] == (
            "proto_3", "prototype_3")
    ref = jax_zoo.decode_predictions(probs, top=top, class_index=jax_index)
    got = zoo.decode_predictions(probs, top=top, class_index=torch_index)
    assert got == ref
    assert all(len(row) == top for row in got)


def test_synthetic_testnet_dataset_matches_jax():
    """The port's copy of TestNet's dataset generator gives the JAX
    package's images and labels, byte for byte."""
    from sparkdl_tpu.models.testnet import synthetic_testnet_dataset as ref
    from sparkdl_tpu_torch.models.testnet import synthetic_testnet_dataset
    for args in ((16, 1), (8, 0, 10.0, 7)):
        (x, y), (rx, ry) = synthetic_testnet_dataset(*args), ref(*args)
        assert x.dtype == rx.dtype == np.uint8 and y.dtype == ry.dtype
        np.testing.assert_array_equal(x, rx)
        np.testing.assert_array_equal(y, ry)


@pytest.mark.parametrize("name", ["InceptionV3", "Xception", "ResNet50",
                                  "VGG16", "VGG19", "TestNet"])
def test_zoo_registry_and_preprocess_match_jax(name):
    """Every model of the JAX zoo is in the port's, with the same input
    size, feature width and class count, and a preprocess that gives the
    JAX package's float32 values exactly (caffe's RGB → BGR flip on the
    NCHW channel axis, then the BGR means). The port's zoo is the JAX
    zoo plus exactly SigLIP so400m/14-384, which the JAX package does
    not carry (``tests/test_torch_siglip.py`` holds it to its plain
    reference)."""
    from sparkdl_tpu.models import zoo as jax_zoo
    from sparkdl_tpu_torch.models import zoo
    assert zoo.SUPPORTED_MODELS == jax_zoo.SUPPORTED_MODELS + (
        "SigLIP-so400m-patch14-384",)
    spec, ref_spec = (zoo.getKerasApplicationModel(name),
                      jax_zoo.getKerasApplicationModel(name))
    assert (spec.input_size, spec.feature_dim, spec.num_classes) == (
        ref_spec.input_size, ref_spec.feature_dim, ref_spec.num_classes)
    x = np.random.default_rng(14).integers(0, 256, (2, 5, 4, 3),
                                           dtype=np.uint8)
    ref = np.asarray(ref_spec.preprocess(jnp.asarray(x)))
    got = spec.preprocess(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(nhwc(got), ref)


# ---------------------------------------------------------------------------
# The conv units' inference epilogue (ops/epilogue.py) against the eager
# chain the units ran before it, with seeded non-identity BatchNorm
# ---------------------------------------------------------------------------

from sparkdl_tpu_torch.ops import epilogue  # noqa: E402


def _seed_units(module, seed=0):
    """Seeded BatchNorm statistics, scales and offsets and conv biases
    (the zoo's init leaves BatchNorm at identity, which would hide a
    missing mean or offset)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, layers.BatchNorm):
                c = m.weight.numel()
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(torch.randn(c, generator=g) * 0.3)
                m.running_mean.copy_(torch.randn(c, generator=g) * 0.3)
                m.running_var.copy_(torch.rand(c, generator=g) + 0.5)
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.copy_(torch.randn(m.bias.numel(), generator=g) * 0.3)
    return module.eval()


def _eager_unit(m, x, train=False, relu=None):
    """A conv unit as it ran before the fused op: the conv with its bf16
    bias, BatchNorm's fp32 formula (the batch's statistics in training),
    the cast back, ReLU."""
    if isinstance(m, layers.SeparableConvBN):
        y = layers.conv2d(x, m.depthwise, "SAME", m.dtype)
        y = layers.conv2d(y, m.pointwise, "SAME", m.dtype)
    else:
        y = layers.conv2d(x, m.conv, m.padding, m.dtype)
    if train:
        y = m.bn(y, True)
    else:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(m.bn.running_var + m.bn.eps) * m.bn.weight
        y = ((y.to(torch.float32) - m.bn.running_mean.view(shape))
             * mul.view(shape) + m.bn.bias.view(shape))
    y = y.to(m.dtype)
    relu = m.relu if relu is None else relu
    return F.relu(y) if relu else y


def _eager_bottleneck(b, x, train=False):
    first = 1 if b.project else 0
    shortcut = _eager_unit(b.ConvBN_0, x, train) if b.project else x
    y = x
    for i in range(first, first + 2):
        y = _eager_unit(getattr(b, f"ConvBN_{i}"), y, train)
    y = _eager_unit(getattr(b, f"ConvBN_{first + 2}"), y, train, relu=False)
    return F.relu(y + shortcut)


def _cl(shape, dtype=torch.float32, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)


# (id, module, eager version, input, conv units the forward runs)
EPILOGUE_UNITS = [
    ("convbn", lambda: layers.ConvBN(5, 16), _eager_unit,
     lambda: _cl((2, 5, 9, 9)), 1),
    ("convbn_biased_no_relu", lambda: layers.ConvBN(
        6, 8, (1, 1), strides=(2, 2), relu=False, bn_epsilon=1.001e-5,
        use_bias=True), _eager_unit, lambda: _cl((2, 6, 9, 8)), 1),
    ("separable", lambda: layers.SeparableConvBN(8, 12), _eager_unit,
     lambda: _cl((2, 8, 7, 7)), 1),
    ("bottleneck", lambda: resnet.Bottleneck(32, 8), _eager_bottleneck,
     lambda: _cl((2, 32, 6, 6), torch.bfloat16), 3),
    ("bottleneck_projected", lambda: resnet.Bottleneck(
        16, 8, strides=(2, 2), project=True), _eager_bottleneck,
     lambda: _cl((2, 16, 8, 8), torch.bfloat16), 4),
]


def _spy_epilogue(monkeypatch):
    calls = []
    fused = epilogue.conv_epilogue

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return fused(*args, **kwargs)
    monkeypatch.setattr(epilogue, "conv_epilogue", spy)
    return calls


def _spy_batchnorm(monkeypatch):
    calls = []
    forward = layers.BatchNorm.forward

    def spy(self, x, train=False):
        calls.append(x.shape)
        return forward(self, x, train)
    monkeypatch.setattr(layers.BatchNorm, "forward", spy)
    return calls


@pytest.mark.parametrize("devices", [("cpu", "cuda"), ("cuda",)],
                         ids=["fused", "cpu_default"])
@pytest.mark.parametrize("case", EPILOGUE_UNITS,
                         ids=[c[0] for c in EPILOGUE_UNITS])
def test_units_through_the_fused_op_equal_the_eager_chain(case, devices,
                                                          monkeypatch):
    """In inference each unit goes through the op once where its device
    fuses the epilogue, and its output is bit for bit what the eager
    chain gave, in the input's layout. By default the CPU keeps the eager
    chain and its calls of ``BatchNorm.forward``, which perfbench's CPU
    tests patch to plant faults."""
    _, make, eager, make_x, units = case
    module, x = _seed_units(make()), make_x()
    monkeypatch.setattr(layers, "EPILOGUE_DEVICES", devices)
    calls = _spy_epilogue(monkeypatch)
    with torch.inference_mode():
        want = eager(module, x)
        bn_calls = _spy_batchnorm(monkeypatch)
        got = module(x)
    fused = "cpu" in devices
    assert len(calls) == (units if fused else 0)
    assert len(bn_calls) == (0 if fused else units)
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("mode", ["train", "grad"])
@pytest.mark.parametrize("case", EPILOGUE_UNITS,
                         ids=[c[0] for c in EPILOGUE_UNITS])
def test_train_and_grad_calls_keep_the_eager_chain(case, mode, monkeypatch):
    """``train=True`` and an eval call that needs gradients never enter
    the op (it has no autograd formula): they run the eager chain,
    gradients flow, and no kernel launches."""
    _, make, eager, make_x, _ = case
    module, x = _seed_units(make()), make_x()
    monkeypatch.setattr(layers, "EPILOGUE_DEVICES", ("cpu", "cuda"))
    calls = _spy_epilogue(monkeypatch)
    epilogue.launches = 0
    train = mode == "train"
    if train:
        ref = copy.deepcopy(module)
        with torch.no_grad():
            got, want = module(x, train=True), eager(ref, x, True)
    else:
        got = module(x)
        with torch.no_grad():
            want = eager(module, x)
        got.float().sum().backward()
        assert all(p.grad is not None for p in module.parameters())
    assert calls == [] and epilogue.launches == 0
    assert torch.equal(got.detach().view(torch.int16),
                       want.view(torch.int16))
