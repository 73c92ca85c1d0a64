"""The port's Keras estimator on the CPU against the JAX package's, with
the same ``.keras`` files, images and seeds.

* The converter split in two: ``convert_model``'s eval outputs equal, bit
  for bit, those the converter gave before the split
  (``tests/data/keras_convert_reference.npz``, recorded from that
  converter over every model ``test_torch_keras.py`` converts); a spec's
  JSON round trip builds the same module; ``tools/keras_spec.py``
  regenerates the committed InceptionV3 topology exactly.
* Training mode of the converted layers against Keras's own
  ``training=True`` call: BatchNormalization (batch moments, Keras's
  momentum, ``scale=False``, a frozen layer staying in inference),
  Dropout.
* Each optimizer name against optax over 20 steps of the same gradients,
  each loss name against the JAX package's ``_resolve_loss``,
  ``_prepare_targets`` on the JAX package's cases.
* Whole fits against ``sparkdl_tpu.KerasImageFileEstimator``: the JAX
  tests' tiny Dense classifier with their ``make_estimator`` settings
  (adam, lr 0.05, 6 epochs, batch 8, seed 1), a small conv model with
  BatchNormalization (also frozen, and without ``gamma``), streaming;
  the batch order index for index, the fingerprints and checkpoint
  directory names byte for byte.
* The port's own guarantees: resume equals an uninterrupted fit,
  parallel trials equal serial ones, ``cacheDecoded`` equals plain
  streaming, ``useMesh`` on one device warns and equals
  ``useMesh=False``, save and load, and a two-process gloo
  data-parallel fit against one process on the global batch (streaming
  and resumed from a checkpoint too).

Tolerances (float32 on both sides; the two packages run the same
arithmetic in another op order, so only rounding separates them):
``TOL_OPT`` for an optimizer's parameters after 20 steps (each step off
by a few ulps of a parameter near 1; measured at most 1.3e-6 for Adam);
``TOL_LOSS`` relative for a loss; ``TOL_FIT`` of the largest |weight|
for a trained weight and ``TOL_HISTORY`` relative (``TOL_HISTORY_ABS``
absolute, for losses that near 0) for the loss history of a whole fit
(measured, over the fits below: at most 3.7e-6 of the largest |weight|,
2.4e-6 relative on losses above 0.1 and 3e-7 absolute on the Dense
fit's, which reach 1e-6 and 0; 9 to 18 Adam steps at lr 0.05);
``TOL_BN`` for a training-mode forward and its moving statistics. Fits
of the port against itself are exact.

This file is also the data-parallel ranks' program: ``python
test_torch_keras_estimator.py <rank> <world> <init file> <model file>
<image dir> <out file>``.
"""

import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_keras import LAYER_CASES, _model, _randomize

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CONVERT_REFERENCE = os.path.join(HERE, "data",
                                 "keras_convert_reference.npz")
H = W = 8
N_IMAGES = 20

TOL_OPT = 1e-5
TOL_LOSS = 1e-6
TOL_FIT = 1e-4
TOL_HISTORY = 1e-4
TOL_HISTORY_ABS = 1e-6
TOL_BN = 1e-5


# -- the converter ------------------------------------------------------------

def _reference_model(name):
    """(Keras model, input) of one model ``test_torch_keras.py``
    converts: a layer case, the export test's model, or one of its
    transformers' three models, each with seeded weights and input."""
    import keras
    L = keras.layers
    if name in LAYER_CASES:
        model, shape = _model(name)
        _randomize(model, seed=len(name))
        x = np.random.default_rng(3).normal(0, 1, (3,) + shape)
        return model, x.astype(np.float32)
    if name == "add_concatenate_export":
        model, shape = _model("add_concatenate")
        _randomize(model, seed=5)
        x = np.random.default_rng(4).normal(0, 1, (2,) + shape)
        return model, x.astype(np.float32)
    rng = np.random.default_rng(8)
    if name == "tensor":
        model = keras.Sequential([L.Input((6,)),
                                  L.Dense(5, activation="relu"), L.Dense(3)])
        return (_randomize(model, seed=1),
                rng.normal(0, 1, (10, 6)).astype(np.float32))
    if name == "image":
        model = keras.Sequential([
            L.Input((8, 8, 3)), L.Conv2D(4, 3, activation="relu",
                                         padding="same"),
            L.BatchNormalization(), L.MaxPooling2D(2), L.Flatten(),
            L.Dense(5, activation="softmax")])
        seed = 2
    else:
        model = keras.Sequential([L.Input((8, 8, 3)),
                                  L.Conv2D(3, 3, padding="same"),
                                  L.Rescaling(60.0, offset=100.0)])
        seed = 3
    return (_randomize(model, seed=seed),
            rng.uniform(0, 1, (7, 8, 8, 3)).astype(np.float32))


REFERENCE_MODELS = LAYER_CASES + ["add_concatenate_export", "tensor",
                                  "image", "trunk"]


def _eval(module, x):
    import torch
    with torch.no_grad():
        return {k: v.numpy() for k, v in
                module.eval()({"input": torch.from_numpy(x)}).items()}


@pytest.mark.parametrize("name", REFERENCE_MODELS)
def test_convert_model_bit_equal_to_recorded_outputs(name):
    from sparkdl_tpu_torch.graph.keras_convert import convert_model
    ref = np.load(CONVERT_REFERENCE)
    model, x = _reference_model(name)
    np.testing.assert_array_equal(x, ref[f"{name}/input"])
    module, *_ = convert_model(model)
    for k, v in _eval(module, x).items():
        np.testing.assert_array_equal(v, ref[f"{name}/{k}"])


@pytest.mark.parametrize("name", REFERENCE_MODELS)
def test_spec_json_round_trip_builds_the_same_module(name):
    """``build_module(from_json(to_json(spec)))`` with the spec's weights
    is bit for bit ``convert_model``; the JSON holds no weights."""
    from sparkdl_tpu_torch.graph.keras_convert import (
        KerasSpec,
        build_module,
        convert_model,
        keras_spec,
    )
    model, x = _reference_model(name)
    spec = keras_spec(model)
    text = spec.to_json()
    back = KerasSpec.from_json(text)
    assert back.weights == {} and "weights" not in json.loads(text)
    assert back.to_json() == text
    back.weights = spec.weights
    ref = _eval(convert_model(model)[0], x)
    got = _eval(build_module(back), x)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


def test_numpy_passes_arrays_through_without_keras(monkeypatch):
    from sparkdl_tpu_torch.graph.keras_convert import _numpy
    monkeypatch.setitem(sys.modules, "keras", None)   # import fails
    got = _numpy(np.arange(3, dtype=np.float64))
    assert got.dtype == np.float32 and got.tolist() == [0.0, 1.0, 2.0]


def test_inception_v3_spec_regenerates_exactly():
    """``tools/keras_spec.py --check`` rebuilds the committed topology
    from ``keras.applications.InceptionV3(weights=None)`` in a fresh
    process (Keras's layer names count from its process start) and
    finds it unchanged."""
    env = dict(os.environ, KERAS_BACKEND="jax", JAX_PLATFORMS="cpu",
               CUDA_VISIBLE_DEVICES="-1", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "keras_spec.py"),
         "--check"], capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]


def test_inception_v3_spec_is_the_full_width_model():
    import collections

    from sparkdl_tpu_torch.graph.keras_convert import KerasSpec, build_module
    path = os.path.join(REPO, "sparkdl_tpu_torch", "models", "keras_specs",
                        "inception_v3.json")
    with open(path) as f:
        text = f.read()
    spec = KerasSpec.from_json(text)
    assert len(text) < 286_000 / 2
    assert spec.input_shape == (299, 299, 3)
    assert spec.output_shapes == [[None, 1000]]
    kinds = collections.Counter(n["class"] for n in spec.nodes)
    assert len(spec.nodes) + 1 == 313      # and the InputLayer
    assert kinds == {"Conv2D": 94, "BatchNormalization": 94,
                     "Activation": 94, "Concatenate": 15,
                     "AveragePooling2D": 9, "MaxPooling2D": 4,
                     "GlobalAveragePooling2D": 1, "Dense": 1}
    bns = [n for n in spec.nodes if n["class"] == "BatchNormalization"]
    assert all(not n["config"]["scale"] for n in bns)
    variables = spec.variables()
    assert sum(int(np.prod(v["shape"])) for v in variables) == 23_851_784
    spec.weights = {v["path"]: np.zeros(v["shape"], np.float32)
                    for v in variables}
    module = build_module(spec)
    assert sum(p.numel() for p in module.parameters()) == sum(
        int(np.prod(v["shape"])) for v in variables if v["trainable"])


def test_variables_are_parameters_or_buffers_as_keras_marks_them():
    """Trainable variables are parameters, the others buffers; each Keras
    path names its tensor, and ``keras_weights`` gives Keras's values
    back exactly (conv, depthwise, pointwise and dense layouts)."""
    import keras

    from sparkdl_tpu_torch.graph.keras_convert import convert_model
    L = keras.layers
    i = L.Input((9, 10, 3))
    y = L.SeparableConv2D(4, 3, padding="same")(i)
    y = L.DepthwiseConv2D(3, depth_multiplier=2)(y)
    frozen = L.BatchNormalization()
    y = frozen(L.Conv2D(5, 3)(y))
    y = L.Dense(2)(L.GlobalAveragePooling2D()(y))
    model = _randomize(keras.Model(i, y), seed=9)
    frozen.trainable = False
    module, *_ = convert_model(model)
    params = dict(module.named_parameters())
    buffers = dict(module.named_buffers())
    assert sorted(module.variables[v.path][0]
                  for v in model.trainable_variables) == sorted(params)
    assert {module.variables[v.path][0]
            for v in model.non_trainable_variables} <= set(buffers)
    got = module.keras_weights()
    assert set(got) == {v.path for v in model.weights}
    for v in model.weights:
        np.testing.assert_array_equal(got[v.path], np.asarray(v.value))


# -- training mode against Keras ----------------------------------------------

def _bn_model(**bn):
    import keras
    L = keras.layers
    return keras.Sequential([L.Input((6, 5, 4)), L.BatchNormalization(**bn),
                             L.Dense(3)])


@pytest.mark.parametrize("bn", [{}, {"scale": False},
                                {"momentum": 0.9, "epsilon": 0.01},
                                {"frozen": True}],
                         ids=["default", "no_scale", "momentum", "frozen"])
def test_batchnorm_training_matches_keras(bn):
    """One ``training=True`` call: the output and the moved statistics
    equal Keras's (Keras 3's rule: batch moments, the biased variance,
    ``moving * momentum + batch * (1 - momentum)``); a frozen layer
    stays in inference mode and moves nothing."""
    import keras
    import torch

    from sparkdl_tpu_torch.graph.keras_convert import convert_model
    frozen = bn.pop("frozen", False)
    model = _randomize(_bn_model(**bn), seed=11)
    layer = model.layers[0]
    layer.trainable = not frozen
    x = np.random.default_rng(12).normal(1.5, 2.0, (7, 6, 5, 4)) \
        .astype(np.float32)
    module, *_ = convert_model(model)
    module.train()
    got = module({"input": torch.from_numpy(x)})["output_0"]
    ref = np.asarray(model(x, training=True))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=TOL_BN * scale)
    stats = module.keras_weights()
    for v in (layer.moving_mean, layer.moving_variance):
        np.testing.assert_allclose(stats[v.path], np.asarray(v.value),
                                   rtol=TOL_BN, atol=TOL_BN)
    if frozen:
        np.testing.assert_array_equal(
            stats[layer.moving_mean.path],
            _randomize(_bn_model(), seed=11).layers[0].moving_mean.numpy())


def test_dropout_is_live_in_training_only():
    import keras
    import torch

    from sparkdl_tpu_torch.graph.keras_convert import convert_model
    model = keras.Sequential([keras.layers.Input((4000,)),
                              keras.layers.Dropout(0.25)])
    module, *_ = convert_model(model)
    x = torch.ones(2, 4000)
    assert torch.equal(module.eval()({"input": x})["output_0"], x)
    module.train()
    draws = []
    for seed in (5, 5, 6):
        gen = torch.Generator().manual_seed(seed)
        module.seed_dropout(gen)
        draws.append(module({"input": x})["output_0"])
    y = draws[0]
    # kept elements scaled by 1 / (1 - rate), the rest 0
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    assert abs(float((y == 0).float().mean()) - 0.25) < 0.02
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])


# -- losses and optimizers ----------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "rmsprop",
                                  "adagrad"])
def test_optimizer_matches_optax_over_20_steps(name):
    """Each name's torch optimizer with optax's defaults against
    ``getattr(optax, name)(lr)`` applied as the JAX estimator applies it
    (``params + updates``), on the same 20 gradients."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from sparkdl_tpu_torch.estimators.keras_image_file_estimator import (
        _resolve_optimizer,
    )
    rng = np.random.default_rng(0)
    p0 = {"w": rng.normal(0, 1, (5, 3)).astype(np.float32),
          "b": rng.normal(0, 1, (3,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(20)]
    tx = getattr(optax, name)(0.01)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = _resolve_optimizer(name, {"learning_rate": 0.01})(
        list(tp.values()))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, updates)
        for k in tp:
            tp[k].grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in tp:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0,
                                       atol=TOL_OPT)
    # the parameters moved far beyond the bound
    assert max(float(np.abs(np.asarray(jp[k]) - p0[k]).max())
               for k in p0) > 100 * TOL_OPT


def test_optimizer_names_and_factories():
    import torch

    from sparkdl_tpu_torch import KerasImageFileEstimator
    from sparkdl_tpu_torch.estimators.keras_image_file_estimator import (
        _resolve_optimizer,
    )
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        _resolve_optimizer("lamb", {})
    with pytest.raises(TypeError, match="unknown optimizer"):
        KerasImageFileEstimator(kerasOptimizer="lamb")

    def factory(params):
        return torch.optim.SGD(params, lr=0.5)

    assert _resolve_optimizer(factory, {}) is factory
    est = KerasImageFileEstimator(kerasOptimizer=factory)
    assert est.getKerasOptimizer() is factory
    p = torch.zeros(2, requires_grad=True)
    opt = _resolve_optimizer("adamw", {"learning_rate": 0.2})([p])
    assert opt.defaults["weight_decay"] == 1e-4
    assert opt.defaults["lr"] == 0.2


@pytest.mark.parametrize("name", [
    "categorical_crossentropy", "binary_crossentropy", "mse",
    "softmax_cross_entropy", "sigmoid_binary_cross_entropy",
    "squared_error", "l2_loss"])
def test_loss_matches_jax(name):
    """Keras-era names take probabilities and clip them at 1e-7 (a
    probability of 0 is in the input); the others are optax's, on
    logits."""
    import jax.numpy as jnp
    import torch

    from sparkdl_tpu.estimators.keras_image_file_estimator import (
        _resolve_loss as jax_loss,
    )
    from sparkdl_tpu_torch.estimators.keras_image_file_estimator import (
        _resolve_loss,
    )
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (6, 4)).astype(np.float32)
    preds = logits
    if name in ("categorical_crossentropy", "binary_crossentropy", "mse"):
        preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        preds[0, 0] = 0.0
    targets = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 6)]
    ref = np.asarray(jax_loss(name)(jnp.asarray(preds),
                                    jnp.asarray(targets)))
    got = _resolve_loss(name)(torch.from_numpy(preds),
                              torch.from_numpy(targets)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=TOL_LOSS, atol=TOL_LOSS)


def test_loss_names_and_callables():
    from sparkdl_tpu_torch import KerasImageFileEstimator
    from sparkdl_tpu_torch.estimators.keras_image_file_estimator import (
        _resolve_loss,
    )
    with pytest.raises(ValueError, match="unknown loss 'huber_loss'"):
        _resolve_loss("huber_loss")
    with pytest.raises(TypeError, match="unknown loss"):
        KerasImageFileEstimator(kerasLoss="huber_loss")

    def mine(p, y):
        return (p - y).abs()

    assert _resolve_loss(mine) is mine


@pytest.mark.parametrize("y,loss,n_out", [
    (np.array([0, 2, 1]), "categorical_crossentropy", 3),
    (np.array([[0.0, 1.0], [1.0, 0.0]]), "mse", 2),
    (np.array([0.0, 1.0, 1.0, 0.0]), "categorical_crossentropy", 2),
    (np.array([0.5, 1.0]), "categorical_crossentropy", 2),
    (np.array([-1.0, 1.0]), "categorical_crossentropy", 2),
    (np.array([0, 3]), "categorical_crossentropy", 2),
    (np.array([0.0, 1.0]), "binary_crossentropy", 1),
], ids=["int", "float_passthrough", "double_ids", "fractional",
        "negative", "out_of_range", "lift"])
def test_prepare_targets_matches_jax(y, loss, n_out):
    from sparkdl_tpu.estimators import KerasImageFileEstimator as J
    from sparkdl_tpu_torch import KerasImageFileEstimator as T
    try:
        ref = J._prepare_targets(y, loss, n_out)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            T._prepare_targets(y, loss, n_out)
        assert str(got.value) == str(e)
        return
    got = T._prepare_targets(y, loss, n_out)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


# -- fits against the JAX package ---------------------------------------------

def loader(uri):
    """The JAX tests' loader: RGB scaled to [-0.5, 0.5]."""
    from PIL import Image
    return np.asarray(Image.open(uri).convert("RGB"),
                      dtype=np.float32) / 255.0 - 0.5


def _write_images(d):
    """The JAX tests' 20 images whose brightness encodes the label."""
    from PIL import Image
    rng = np.random.default_rng(7)
    rows = []
    for i in range(N_IMAGES):
        label = i % 2
        base = 40 if label == 0 else 210
        arr = np.clip(rng.normal(base, 15, (H, W, 3)), 0, 255).astype(
            np.uint8)
        p = os.path.join(d, f"i{i}.png")
        Image.fromarray(arr, "RGB").save(p)
        rows.append({"uri": p, "label": label})
    return rows


def _rows(d):
    return [{"uri": os.path.join(d, f"i{i}.png"), "label": i % 2}
            for i in range(N_IMAGES)]


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("kest_images"))
    _write_images(d)
    return d


def _save(model, d, name):
    path = os.path.join(d, name)
    model.save(path)
    return path


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    """The JAX tests' Dense classifier, and the conv model in three
    BatchNormalization variants: trainable with gamma, ``scale=False``,
    frozen. Its conv has no bias, as keras.applications' convs before a
    BatchNorm: the BatchNorm cancels a bias's gradient, and Adam then
    scales rounding noise up to full steps, which no two programs
    share."""
    import keras
    L = keras.layers
    d = str(tmp_path_factory.mktemp("kest_models"))
    keras.utils.set_random_seed(123)
    files = {"dense": _save(keras.Sequential([
        L.Input((H, W, 3)), L.Flatten(), L.Dense(8, activation="relu"),
        L.Dense(2, activation="softmax")]), d, "dense.keras")}
    for variant in ("bn", "bn_no_scale", "bn_frozen"):
        keras.utils.set_random_seed(5)
        bn = L.BatchNormalization(scale=variant != "bn_no_scale")
        model = keras.Sequential([
            L.Input((H, W, 3)),
            L.Conv2D(4, 3, padding="same", use_bias=False), bn,
            L.ReLU(), L.MaxPooling2D(2), L.GlobalAveragePooling2D(),
            L.Dropout(0.0), L.Dense(2, activation="softmax")])
        if variant == "bn_frozen":
            bn.trainable = False
        files[variant] = _save(model, d, f"{variant}.keras")
    return files


FIT = {"epochs": 6, "batch_size": 8, "learning_rate": 0.05, "seed": 1}


def _kw(model_file, **over):
    kw = dict(inputCol="uri", outputCol="prediction", labelCol="label",
              modelFile=model_file, imageLoader=loader,
              kerasOptimizer="adam", kerasLoss="categorical_crossentropy",
              kerasFitParams=dict(FIT), batchSize=8)
    kw.update(over)
    return kw


def _jax_fit(model_file, rows, order=None, **over):
    """The JAX estimator's fit; ``order`` collects each step's batch."""
    import sparkdl_tpu
    from sparkdl_tpu.estimators import keras_image_file_estimator as jkest
    est = sparkdl_tpu.KerasImageFileEstimator(**_kw(model_file, **over))
    if order is not None:
        real = jkest.KerasImageFileEstimator._compile_step

        def recording(self, step, batch_size):
            jitted, batch_size, mesh = real(self, step, batch_size)

            def run(tr, nt, opt, xb, yb):
                order.append(np.asarray(xb))
                return jitted(tr, nt, opt, xb, yb)
            return run, batch_size, mesh

        est._compile_step = recording.__get__(est)
    return est.fit(sparkdl_tpu.DataFrame.from_pylist(rows, num_partitions=3))


def _port_fit(model_file, rows, order=None, **over):
    """The port's fit on the CPU; ``order`` collects each step's
    batch."""
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.estimators import keras_image_file_estimator as k
    kw = _kw(model_file, **over)
    kw.setdefault("device", "cpu")
    est = sparkdl_tpu_torch.KerasImageFileEstimator(**kw)
    df = sparkdl_tpu_torch.DataFrame.from_pylist(rows, num_partitions=3)
    if order is None:
        return est.fit(df)
    real = k._Trial.run_step

    def recording(self, xb, yb):
        order.append(np.array(xb))
        return real(self, xb, yb)

    mp = pytest.MonkeyPatch()
    mp.setattr(k._Trial, "run_step", recording)
    try:
        return est.fit(df)
    finally:
        mp.undo()


def _jax_variables(model_file, fitted):
    """The JAX fit's trained variables by Keras path."""
    import keras
    model = keras.models.load_model(model_file, compile=False)
    params = fitted.modelFunction.params
    out = {}
    for group, variables in (("trainable", model.trainable_variables),
                             ("non_trainable",
                              model.non_trainable_variables)):
        for v, value in zip(variables, params[group]):
            out[v.path] = np.asarray(value)
    return out


def _assert_fit_close(port, jax_fit, model_file):
    np.testing.assert_allclose(port.history, jax_fit.history,
                               rtol=TOL_HISTORY, atol=TOL_HISTORY_ABS)
    ref = _jax_variables(model_file, jax_fit)
    got = port.modelFunction.module.keras_weights()
    assert set(got) == set(ref)
    for path, value in ref.items():
        np.testing.assert_allclose(
            got[path], value, rtol=0,
            atol=TOL_FIT * max(1.0, float(np.abs(value).max())),
            err_msg=path)


@pytest.fixture(scope="module")
def dense_fits(model_files, images):
    """The Dense classifier fitted by both packages with the JAX tests'
    settings, each step's batch recorded."""
    rows = _rows(images)
    j_order, t_order = [], []
    jfit = _jax_fit(model_files["dense"], rows, j_order)
    tfit = _port_fit(model_files["dense"], rows, t_order)
    return jfit, tfit, j_order, t_order


def test_dense_fit_batch_order_equals_jax(dense_fits):
    _, _, j_order, t_order = dense_fits
    assert len(t_order) == len(j_order) == 6 * 3
    for a, b in zip(t_order, j_order):
        np.testing.assert_array_equal(a, b)


def test_dense_fit_matches_jax(dense_fits, model_files):
    jfit, tfit, _, _ = dense_fits
    assert len(tfit.history) == 6
    assert tfit.history[-1] < tfit.history[0]
    _assert_fit_close(tfit, jfit, model_files["dense"])
    assert tfit.fitStats["device"] == "cpu"


def test_dense_fit_transform_matches_jax(dense_fits, images):
    import sparkdl_tpu
    import sparkdl_tpu_torch
    jfit, tfit, _, _ = dense_fits
    rows = _rows(images)
    ref = jfit.transform(sparkdl_tpu.DataFrame.from_pylist(
        rows, num_partitions=3)).tensor("prediction")
    got = tfit.transform(sparkdl_tpu_torch.DataFrame.from_pylist(
        rows, num_partitions=3)).tensor("prediction")
    assert got.shape == ref.shape == (N_IMAGES, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL_FIT)
    labels = np.arange(N_IMAGES) % 2
    assert float(np.mean(got.argmax(-1) == labels)) >= 0.8


@pytest.mark.parametrize("variant", ["bn", "bn_no_scale", "bn_frozen"])
def test_conv_batchnorm_fit_matches_jax(variant, model_files, images):
    """Conv2D → BatchNormalization → ReLU → MaxPool → GAP → Dropout(0) →
    Dense softmax: history, trained weights and moving statistics within
    the bounds of the JAX fit; a frozen BatchNorm's statistics do not
    move."""
    rows = _rows(images)
    fit = dict(FIT, epochs=3)
    jfit = _jax_fit(model_files[variant], rows, kerasFitParams=fit)
    tfit = _port_fit(model_files[variant], rows, kerasFitParams=fit)
    _assert_fit_close(tfit, jfit, model_files[variant])
    weights = tfit.modelFunction.module.keras_weights()
    moving = [v for p, v in weights.items() if "moving_mean" in p]
    assert len(moving) == 1
    assert (not moving[0].any()) == (variant == "bn_frozen")


def test_streaming_fit_matches_jax(model_files, images):
    """Streaming (partition order and in-partition rows shuffled per
    epoch, the cyclic tail) feeds the JAX package's batches, index for
    index."""
    rows = _rows(images)
    fit = dict(FIT, epochs=3)
    j_order, t_order = [], []
    jfit = _jax_fit(model_files["bn"], rows, j_order, kerasFitParams=fit,
                    streaming=True)
    tfit = _port_fit(model_files["bn"], rows, t_order, kerasFitParams=fit,
                     streaming=True)
    assert len(t_order) == len(j_order) == 3 * 3
    for a, b in zip(t_order, j_order):
        np.testing.assert_array_equal(a, b)
    _assert_fit_close(tfit, jfit, model_files["bn"])


def test_fingerprints_and_trial_directories_equal_jax(model_files, images,
                                                      tmp_path):
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu.estimators import keras_image_file_estimator as jk
    from sparkdl_tpu_torch.estimators import keras_image_file_estimator as tk
    kw = _kw(model_files["dense"], kerasFitParams=dict(FIT, epochs=1),
             checkpointDir=str(tmp_path / "ck"))
    jest = sparkdl_tpu.KerasImageFileEstimator(**kw)
    test = sparkdl_tpu_torch.KerasImageFileEstimator(device="cpu", **kw)
    assert tk._config_fingerprint_bytes(test) == \
        jk._config_fingerprint_bytes(jest)
    rng = np.random.default_rng(3)
    X = rng.normal(0, 1, (20, H, W, 3)).astype(np.float32)
    y = np.arange(20) % 2
    assert test._trial_fingerprint(test, X, y) == \
        jest._trial_fingerprint(jest, X, y)
    uris = [r["uri"] for r in _rows(images)]
    labels = [r["label"] for r in _rows(images)]
    assert test._streaming_fingerprint(test, uris, labels) == \
        jest._streaming_fingerprint(jest, uris, labels)
    rows = _rows(images)
    dirs = {}
    for name, pkg, est in (("jax", sparkdl_tpu, jest),
                           ("port", sparkdl_tpu_torch, test)):
        for streaming in (False, True):
            d = str(tmp_path / f"{name}_{streaming}")
            est.copy({est.getParam("checkpointDir"): d,
                      est.getParam("streaming"): streaming}).fit(
                pkg.DataFrame.from_pylist(rows, num_partitions=3))
            dirs[name, streaming] = os.listdir(d)
    assert dirs["port", False] == dirs["jax", False]
    assert dirs["port", True] == dirs["jax", True]
    assert dirs["port", False] != dirs["port", True]


# -- the port's own guarantees ------------------------------------------------

def _same_fit(a, b):
    assert a.history == b.history
    wa = a.modelFunction.module.keras_weights()
    wb = b.modelFunction.module.keras_weights()
    assert set(wa) == set(wb)
    for k in wa:
        np.testing.assert_array_equal(wa[k], wb[k], err_msg=k)


@pytest.mark.parametrize("streaming", [False, True])
def test_resume_equals_uninterrupted(model_files, images, tmp_path,
                                     streaming):
    rows = _rows(images)
    fit = dict(FIT, epochs=4)
    full = _port_fit(model_files["bn"], rows, kerasFitParams=fit,
                     streaming=streaming)
    ck = str(tmp_path / "ck")
    first = _port_fit(model_files["bn"], rows, kerasFitParams=dict(
        fit, epochs=2), checkpointDir=ck, streaming=streaming)
    assert first.resumedFrom == 0
    resumed = _port_fit(model_files["bn"], rows, kerasFitParams=fit,
                        checkpointDir=ck, streaming=streaming)
    assert len(os.listdir(ck)) == 1
    assert resumed.resumedFrom == 2
    assert resumed.fitStats["restore_s"] > 0
    _same_fit(resumed, full)


def test_resume_with_dropout_keeps_the_generator(images, tmp_path):
    """A model with live dropout resumes onto the same masks: the
    dropout generator's state is part of the checkpoint."""
    import keras
    keras.utils.set_random_seed(3)
    L = keras.layers
    path = _save(keras.Sequential([
        L.Input((H, W, 3)), L.Flatten(), L.Dense(8, activation="relu"),
        L.Dropout(0.5), L.Dense(2, activation="softmax")]), str(tmp_path),
        "drop.keras")
    rows = _rows(images)
    fit = dict(FIT, epochs=3)
    full = _port_fit(path, rows, kerasFitParams=fit)
    again = _port_fit(path, rows, kerasFitParams=fit)
    _same_fit(again, full)
    other = _port_fit(path, rows, kerasFitParams=dict(fit, seed=2))
    assert other.history != full.history
    ck = str(tmp_path / "ck")
    _port_fit(path, rows, kerasFitParams=dict(fit, epochs=1),
              checkpointDir=ck)
    resumed = _port_fit(path, rows, kerasFitParams=fit, checkpointDir=ck)
    assert resumed.resumedFrom == 1
    _same_fit(resumed, full)


def test_fit_multiple_parallel_equals_serial(model_files, images):
    import sparkdl_tpu_torch
    rows = _rows(images)
    est = sparkdl_tpu_torch.KerasImageFileEstimator(
        device="cpu", parallelism=2, **_kw(model_files["bn"]))
    grid = [{est.getParam("kerasFitParams"): dict(FIT, epochs=2)},
            {est.getParam("kerasFitParams"): dict(FIT, epochs=3,
                                                  batch_size=4)}]
    df = sparkdl_tpu_torch.DataFrame.from_pylist(rows, num_partitions=3)
    got = dict(est.fitMultiple(df, grid))
    assert set(got) == {0, 1}
    for i, pm in enumerate(grid):
        _same_fit(got[i], est.fit(df, pm))


def test_cache_decoded_equals_plain_streaming(model_files, images):
    calls = {"n": 0}

    def counting_loader(uri):
        calls["n"] += 1
        return loader(uri)

    rows = _rows(images)
    fit = dict(FIT, epochs=3)
    plain = _port_fit(model_files["bn"], rows, kerasFitParams=fit,
                      streaming=True, imageLoader=counting_loader)
    assert calls["n"] == 3 * N_IMAGES
    calls["n"] = 0
    cached = _port_fit(model_files["bn"], rows, kerasFitParams=fit,
                       streaming=True, cacheDecoded=True,
                       imageLoader=counting_loader)
    assert calls["n"] == N_IMAGES
    _same_fit(cached, plain)


def test_use_mesh_on_one_device_warns_once_and_matches(model_files, images,
                                                       caplog):
    rows = _rows(images)
    fit = dict(FIT, epochs=2)
    plain = _port_fit(model_files["bn"], rows, kerasFitParams=fit,
                      useMesh=False)
    with caplog.at_level(logging.WARNING):
        meshed = _port_fit(model_files["bn"], rows, kerasFitParams=fit,
                           useMesh=True)
    warned = [r for r in caplog.records
              if "useMesh requested" in r.getMessage()]
    assert len(warned) == 1
    _same_fit(meshed, plain)


def test_save_and_load_fitted_model(dense_fits, images, tmp_path):
    import sparkdl_tpu_torch
    _, tfit, _, _ = dense_fits
    path = str(tmp_path / "kifm")
    tfit.save(path)
    back = sparkdl_tpu_torch.load_model(path, trusted_modules=[__name__])
    assert back.history == tfit.history
    assert back.resumedFrom == tfit.resumedFrom
    assert back.getImageLoader() is loader
    df = sparkdl_tpu_torch.DataFrame.from_pylist(_rows(images),
                                                 num_partitions=3)
    np.testing.assert_array_equal(back.transform(df).tensor("prediction"),
                                  tfit.transform(df).tensor("prediction"))


def test_fit_errors(model_files, images):
    import sparkdl_tpu_torch
    est = sparkdl_tpu_torch.KerasImageFileEstimator(
        inputCol="uri", outputCol="p", modelFile=model_files["dense"],
        imageLoader=loader, device="cpu")
    df = sparkdl_tpu_torch.DataFrame.from_pylist(_rows(images), 3)
    with pytest.raises(ValueError, match="labelCol"):
        est.fit(df)
    # a batch larger than twice the data still gives full batches
    big = _port_fit(model_files["dense"], _rows(images), kerasFitParams={
        "epochs": 2, "batch_size": 64, "learning_rate": 0.01, "seed": 1})
    assert len(big.history) == 2


# -- two processes, data-parallel ---------------------------------------------

WORLD = 2
DP_FIT = {"epochs": 2, "batch_size": 8, "learning_rate": 0.05, "seed": 1}


def _result(model):
    return {"history": model.history,
            "weights": {k: v.tolist() for k, v in
                        model.modelFunction.module.keras_weights().items()}}


def _worker(rank, world, init_file, model_file, image_dir, out_file):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from sparkdl_tpu_torch import DataFrame, KerasImageFileEstimator
    from sparkdl_tpu_torch.parallel import initialize
    initialize(f"file://{init_file}", world, rank, device="cpu")
    df = DataFrame.from_pylist(_rows(image_dir), num_partitions=4)
    est = KerasImageFileEstimator(device="cpu", useMesh=True,
                                  **_kw(model_file, kerasFitParams=DP_FIT))
    res = {}
    for name, e in (("in_memory", est),
                    ("streaming",
                     est.copy({est.getParam("streaming"): True}))):
        m = e.fit(df)
        res[name] = _result(m)
    # one epoch with checkpoints (process 0 writes), then resumed to two
    # from the step both processes agree on
    ck = os.path.join(os.path.dirname(out_file), "ck")
    est.copy({est.getParam("checkpointDir"): ck,
              est.getParam("kerasFitParams"): dict(DP_FIT, epochs=1)}
             ).fit(df)
    m = est.copy({est.getParam("checkpointDir"): ck}).fit(df)
    res["resumed"] = dict(_result(m), resumed_from=m.resumedFrom)
    with open(out_file, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def dp_results(model_files, images, tmp_path_factory):
    root = tmp_path_factory.mktemp("kest_dp")
    env = dict(os.environ)
    env.update({"PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "-1",
                "KERAS_BACKEND": "jax", "JAX_PLATFORMS": "cpu",
                "OMP_NUM_THREADS": "1"})
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    outs = [str(root / f"{r}.json") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(WORLD),
         str(root / "init"), model_files["bn"], images, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=HERE) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-3000:]}"
    results = []
    for path in outs:
        with open(path) as f:
            results.append(json.load(f))
    return results


def test_data_parallel_fit_matches_one_process(dp_results, model_files,
                                               images):
    """Two gloo ranks, each on 4 rows of every global batch of 8 (the
    BatchNorm moments all-reduced, the gradients averaged) against one
    process on the whole batch: the same history and weights within
    ``TOL_FIT`` (the moments and gradients summed in another order), and
    the ranks in lockstep."""
    ref = _port_fit(model_files["bn"], _rows(images), kerasFitParams=DP_FIT,
                    useMesh=False)
    ref_w = ref.modelFunction.module.keras_weights()
    first = dp_results[0]["in_memory"]
    np.testing.assert_allclose(first["history"], ref.history,
                               rtol=TOL_HISTORY, atol=TOL_HISTORY_ABS)
    assert set(first["weights"]) == set(ref_w)
    for k, v in ref_w.items():
        np.testing.assert_allclose(
            np.asarray(first["weights"][k], np.float32), v, rtol=0,
            atol=TOL_FIT * max(1.0, float(np.abs(v).max())), err_msg=k)
    for r in dp_results[1:]:
        assert r == dp_results[0]


def test_data_parallel_resume_equals_uninterrupted(dp_results):
    for r in dp_results:
        resumed = dict(r["resumed"])
        assert resumed.pop("resumed_from") == 1
        assert resumed == r["in_memory"]


def test_data_parallel_streaming_ranks_in_lockstep(dp_results):
    """Streaming over two processes: each streams its own partitions,
    both take the same steps and end on the same weights."""
    first = dp_results[0]["streaming"]
    assert len(first["history"]) == DP_FIT["epochs"]
    assert all(np.isfinite(first["history"]))
    for r in dp_results[1:]:
        assert r["streaming"] == first


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5], sys.argv[6])
