"""The port's models (``sparkdl_tpu_torch.models``) against the JAX
package's flax models on the CPU, through the weight bridge
(``models/convert.py``).

The JAX side takes its variables from ``jax.eval_shape(module.init, ...)``
filled from numpy — BatchNorm statistics random, not the seeded init's
mean 0 / var 1, which would hide a BatchNorm bug — and runs un-jitted.
Each comparison states its tolerance:

* float32: ``TOL_F32`` of the reference's largest magnitude — the two
  sides differ only in the order of float32 sums.
* bfloat16: two rounding steps (``TOL_BF16_LAYER``) for one layer or
  block and four (``TOL_BF16_NET``) for the whole InceptionV3, as
  max|diff| over the reference's largest magnitude. bf16 keeps 8
  significant bits (a step is 2^-8 ≈ 3.9e-3 relative); where the two
  sides' fp32 accumulations land on either side of a rounding boundary
  the result differs by a step, and a deep net carries such flips
  forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparkdl_tpu.models import inception as jax_inception
from sparkdl_tpu.models import layers as jax_layers
from sparkdl_tpu.models import testnet as jax_testnet
from sparkdl_tpu_torch.models import inception, layers, testnet
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
