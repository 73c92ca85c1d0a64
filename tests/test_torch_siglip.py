"""SigLIP so400m/14 at 384 in the port (``models/siglip.py``), a model the
JAX package does not carry, held to the plain float32 reference
``tests/siglip_reference.py`` on seeded random weights at a small size:
hidden 64, 2 blocks, 4 heads of 16, MLP 96, patch 14, 56×56 input (16
tokens). The weights come from the benchmark's seeding
(``perfbench/weights.py``) with its copy's kinds, so every LayerNorm
scale and offset and every bias moves the output. At the published
widths the checks run on the ``meta`` device only."""

import functools
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import siglip_reference as ref
from perfbench.reference import siglip_so400m as bench_ref
from perfbench.weights import make_state
from sparkdl_tpu_torch.models import layers, siglip, zoo
from sparkdl_tpu_torch.obs import default_registry
from sparkdl_tpu_torch.obs import trace as t_trace

NAME = "SigLIP-so400m-patch14-384"
SMALL = dict(hidden=64, layers=2, mlp=96, patch=14, image=56)
HEADS = 4
SCHEME = {"bn_gamma": [0.8, 1.2], "bn_beta_std": 0.2, "bias_std": 0.2,
          "embedding_std": 0.2}
# the same operations in another order (SDPA against an explicit
# softmax, fused addmm against matmul then add): float32 rounding only;
# readings 4.9e-7 to 7.0e-7 over seeds 0-9
TOL_F32 = 1e-5
# bf16 keeps 8 significant bits (a relative step of 2^-8): the token
# stream, every product's operands and result and every activation are
# rounded, about fifteen roundings in sequence a block; readings 0.0088
# to 0.0125 over seeds 0-9
TOL_BF16 = 0.03


def small_state(seed=0):
    return make_state(bench_ref.param_shapes(**SMALL), seed, "cpu", SCHEME,
                      bench_ref.param_kinds(**SMALL))


def small_images(n=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 56, 56, 3), dtype=torch.uint8,
                         generator=g)


def small_model(state, dtype):
    net = siglip.SigLIP(heads=HEADS, dtype=dtype, **SMALL)
    net.load_state_dict(state)
    return net


def port_features(net, x):
    with torch.no_grad():
        return net(zoo._inception_preprocess(x.permute(0, 3, 1, 2)))


def worst_row(got, want):
    got, want = got.double(), want.double()
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_reference_in_float32(seed):
    state, x = small_state(seed), small_images(seed=seed)
    err = worst_row(port_features(small_model(state, torch.float32), x),
                    ref.forward(state, x, heads=HEADS))
    assert err <= TOL_F32


def test_port_matches_the_reference_in_bf16():
    state, x = small_state(), small_images()
    got = port_features(small_model(state, torch.bfloat16), x)
    assert got.dtype == torch.float32 and got.shape == (6, 64)
    assert worst_row(got, ref.forward(state, x, heads=HEADS)) <= TOL_BF16


def _erf_gelu(monkeypatch):
    monkeypatch.setattr(siglip, "gelu_tanh", F.gelu)


def _no_position_embedding(monkeypatch):
    def forward(self, x):
        y = self.patch_embedding(x.to(self.dtype))
        return y.flatten(2).transpose(1, 2)
    monkeypatch.setattr(siglip.Embeddings, "forward", forward)


def _head_without_mlp_residual(monkeypatch):
    def forward(self, x):
        h = self.attention(self.probe.expand(x.shape[0], -1, -1), x)
        return self.mlp(self.layernorm(h))[:, 0]
    monkeypatch.setattr(siglip.PoolingHead, "forward", forward)


PLANTS = {"erf_gelu": (_erf_gelu, torch.float32),
          "no_position_embedding": (_no_position_embedding, torch.float32),
          "head_without_mlp_residual": (_head_without_mlp_residual,
                                        torch.float32),
          "bf16": (lambda monkeypatch: None, torch.bfloat16)}


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_each_plant_fails_the_float32_tolerance(plant, monkeypatch):
    apply, dtype = PLANTS[plant]
    apply(monkeypatch)
    state, x = small_state(), small_images()
    err = worst_row(port_features(small_model(state, dtype), x),
                    ref.forward(state, x, heads=HEADS))
    assert err > TOL_F32


def test_the_benchmark_copy_gives_the_reference_exactly():
    state, x = small_state(3), small_images(seed=3)
    assert torch.equal(bench_ref.forward(state, x, heads=HEADS),
                       ref.forward(state, x, heads=HEADS))
    assert bench_ref.param_shapes(**SMALL) == ref.param_shapes(**SMALL)


def test_published_widths_keys_shapes_and_parameters():
    """On the meta device: the port's state dict is the copy's
    ``param_shapes()``, key for key and in order, 428,225,600
    parameters; ``param_kinds()`` names every key."""
    with torch.device("meta"):
        net = siglip.SigLIP()
    shapes = bench_ref.param_shapes()
    assert [(k, tuple(v.shape)) for k, v in net.state_dict().items()] == \
        shapes == ref.param_shapes()
    assert sum(math.prod(s) for _, s in shapes) == 428_225_600
    kinds = bench_ref.param_kinds()
    assert list(kinds) == [k for k, _ in shapes]
    assert kinds["head.probe"] == "embedding"
    assert kinds["encoder.layers.26.layer_norm2.bias"] == "beta"
    assert kinds["head.attention.in_proj_weight"] == "kernel"


def test_published_widths_flops_per_image():
    """``FlopCounterMode`` over the copy on the meta device: 670.35 GFLOP
    an image (a multiply-add is two)."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        state = {k: torch.empty(s) for k, s in bench_ref.param_shapes()}
        x = torch.empty((1, 384, 384, 3), dtype=torch.uint8)
        with FlopCounterMode(display=False) as counter:
            bench_ref.forward(state, x)
    assert counter.get_total_flops() == pytest.approx(670.35e9, rel=1e-3)


@pytest.fixture
def small_zoo(monkeypatch, tmp_path):
    """A small SigLIP registered in the zoo under a name of its own, with
    a fresh weight cache; yields its name."""
    name = "SigLIP-small-test"
    monkeypatch.setitem(zoo.KERAS_APPLICATION_MODELS, name,
                        zoo.NamedImageModel(
                            name, functools.partial(siglip.SigLIP,
                                                    heads=HEADS, **SMALL),
                            (56, 56), zoo._inception_preprocess, 64,
                            num_classes=None))
    monkeypatch.setenv("SPARKDL_TPU_TORCH_MODEL_CACHE", str(tmp_path))
    yield name
    zoo.init_state_dict.cache_clear()


def test_featurizer_end_to_end_through_the_zoo(small_zoo):
    """``DeepImageFeaturizer`` with the small registered SigLIP on the
    CPU, through the zoo's weight cache, the frame and the runner,
    against the reference; ``DeepImagePredictor`` is refused."""
    import sparkdl_tpu_torch as pkg
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher
    state = small_state(4)
    ModelFetcher().put(f"{small_zoo}.pt", state)
    x = small_images(10, seed=4)
    df = pkg.DataFrame.from_pylist(
        [{"image": imageArrayToStruct(i)} for i in x.numpy()],
        num_partitions=3)
    out = pkg.DeepImageFeaturizer(
        modelName=small_zoo, inputCol="image", outputCol="f", batchSize=4,
        device="cpu").transform(df).collect()
    got = torch.from_numpy(np.asarray(out["f"]))
    assert got.shape == (10, 64)
    assert worst_row(got, ref.forward(state, x, heads=HEADS)) <= TOL_BF16
    with pytest.raises(ValueError, match="no classifier"):
        pkg.DeepImagePredictor(modelName=small_zoo, inputCol="image",
                               outputCol="p", device="cpu").transform(df)


def test_the_published_model_is_a_featurizer_without_a_classifier():
    spec = zoo.getKerasApplicationModel(NAME)
    assert (spec.input_size, spec.feature_dim, spec.num_classes) == (
        (384, 384), 1152, None)
    assert spec.preprocess is zoo._inception_preprocess
    with pytest.raises(ValueError, match="no classifier"):
        zoo.getModelFunction(NAME, featurize=False, device="cpu")


def test_seeded_init_gives_rows_that_differ(small_zoo):
    """The zoo's seeded init gives LayerNorm scale 1 and offset 0, so a
    seeded-random SigLIP's features differ from row to row."""
    state = zoo.init_state_dict(small_zoo)
    assert torch.equal(state["encoder.layers.0.layer_norm1.weight"],
                       torch.ones(64))
    assert torch.equal(state["head.layernorm.bias"], torch.zeros(64))
    assert state["head.attention.in_proj_weight"].std() > 0
    got = port_features(small_model(state, torch.bfloat16), small_images())
    dist = torch.cdist(got.double(), got.double())
    dist.fill_diagonal_(float("inf"))
    assert float(dist.min()) > 1e-3 * float(got.norm(dim=1).max())


def test_attention_calls_are_counted():
    """One ``model.attention.calls`` per block and one for the head."""
    counter = default_registry().counter("model.attention.calls")
    before = counter.value
    port_features(small_model(small_state(), torch.bfloat16),
                  small_images(2))
    assert counter.value - before == SMALL["layers"] + 1


def test_card_attention_never_takes_the_math_fallback():
    names = set(torch.nn.attention.SDPBackend.__members__)
    assert set(layers.FUSED_ATTENTION) <= names
    assert "MATH" not in layers.FUSED_ATTENTION


class _Stream:
    """A stand-in CUDA stream: a device clock the test moves."""

    def __init__(self):
        self.device_index, self.stream_id = 0, 5
        self.now, self.completed = 1.0, float("inf")


class _Event:
    """A stand-in timing event on a :class:`_Stream`."""

    def __init__(self, enable_timing=False):
        self.stream = self.t = None

    def record(self, stream):
        self.stream, self.t = stream, stream.now

    def query(self):
        return self.t <= self.stream.completed

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_each_block_records_its_card_spans_inside_card_compute(
        monkeypatch):
    """Armed, inside a chunk's ``card.compute`` each block records one
    ``card.attention`` and one ``card.mlp``, nested in it with its chunk;
    disarmed, the model records nothing."""
    t = t_trace.Tracer()
    t.event_type = _Event
    monkeypatch.setattr(t_trace, "_TRACER", t)
    net, x = small_model(small_state(), torch.bfloat16), small_images(2)
    port_features(net, x)
    assert t.card_spans() == [] and t.spans() == []
    t.arm()
    stream = _Stream()
    t.anchor(0, stream=stream)
    with t.card_span("card.compute", stream, chunk=3):
        port_features(net, x)
    cards = t.card_spans()
    (compute,) = [c for c in cards if c.name == "card.compute"]
    for name in ("card.attention", "card.mlp"):
        block = [c for c in cards if c.name == name]
        assert len(block) == SMALL["layers"]
        assert all(c.parent == compute.span_id and c.attrs["chunk"] == 3
                   for c in block)
    assert t.dropped == 0
