"""The port's graph toolkit against the JAX package's, on the CPU: the
``ModelFunction`` (``fromSingle``, ``output_signature``, ``fromList`` and
its refusal, ``rename_io``), the converter pieces, ``ModelIngest``
(``fromFunction``, the export round trip with a symbolic and a fixed
batch, the fixed batch carried through the wrappers, ``fromKerasModel``,
``fromKerasFile`` and the ``TFInputGraph`` alias), mirroring
``tests/test_graph.py``; K1 and K2 as registered ops (``opcheck``, and a
``deviceResizeModel`` exported and reloaded with the op in its graph);
and the runner's empty-partition outputs taken from the output
signature without running the model.

The same seeded numpy weights and inputs go through both packages: one
tiny MLP, a torch function on the port's side and a jax one on the JAX
package's. float32 on both sides, so they differ by the order of float32
sums: ``TOL_F32`` of the reference's largest magnitude (as
``tests/test_torch_models.py``). A function and its export reloaded in
the same package run the same kernels in the same order: equal bits.
"""

import numpy as np
import pytest
import torch

import jax

from sparkdl_tpu_torch.graph import (
    ModelFunction,
    ModelIngest,
    TFInputGraph,
    buildFlattener,
    buildSpImageConverter,
)
from sparkdl_tpu_torch.graph import utils as tfx
import sparkdl_tpu_torch.ops  # noqa: F401  (registers K1 and K2)

TOL_F32 = 1e-5
IN_DIM, HID, OUT_DIM = 4, 8, 3


@pytest.fixture(scope="module")
def mlp_weights():
    r = np.random.default_rng(1)
    return {
        "W1": r.normal(size=(IN_DIM, HID)).astype(np.float32),
        "b1": r.normal(size=(HID,)).astype(np.float32),
        "W2": r.normal(size=(HID, OUT_DIM)).astype(np.float32),
        "b2": r.normal(size=(OUT_DIM,)).astype(np.float32),
    }


def jax_mlp(params, x):
    h = jax.nn.relu(x @ params["W1"] + params["b1"])
    return h @ params["W2"] + params["b2"]


def torch_mlp(params, x):
    h = torch.relu(x @ params["W1"] + params["b1"])
    return h @ params["W2"] + params["b2"]


@pytest.fixture(scope="module")
def x_batch():
    return np.random.default_rng(2).normal(size=(6, IN_DIM)) \
        .astype(np.float32)


@pytest.fixture(scope="module")
def jax_single(mlp_weights):
    from sparkdl_tpu.graph import ModelFunction as JaxModelFunction
    return JaxModelFunction.fromSingle(jax_mlp, mlp_weights,
                                       input_shape=(IN_DIM,))


@pytest.fixture(scope="module")
def expected(jax_single, x_batch):
    return np.asarray(jax_single(x_batch))


def port_single(mlp_weights):
    return ModelFunction.fromSingle(torch_mlp, mlp_weights,
                                    input_shape=(IN_DIM,), device="cpu")


def assert_close(got, ref):
    if isinstance(got, dict):
        (got,) = got.values()
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=TOL_F32 * np.abs(ref).max())


class TestModelFunction:
    def test_from_single_call(self, mlp_weights, x_batch, expected):
        assert_close(port_single(mlp_weights)(x_batch), expected)

    def test_output_signature(self, mlp_weights, jax_single):
        sig = port_single(mlp_weights).output_signature()
        ref = jax_single.output_signature()
        assert sig == {"output": ((OUT_DIM,), np.dtype(np.float32))}
        assert sig["output"][0] == ref["output"][0]
        assert np.dtype(ref["output"][1]) == sig["output"][1]

    def test_from_list_composition(self, mlp_weights, x_batch, expected):
        from sparkdl_tpu.graph import ModelFunction as JaxModelFunction
        from sparkdl_tpu.graph import buildFlattener as jax_flattener
        composed = ModelFunction.fromList(
            [port_single(mlp_weights),
             buildFlattener(input_shape=(OUT_DIM,), device="cpu")])
        ref = JaxModelFunction.fromList(
            [JaxModelFunction.fromSingle(jax_mlp, mlp_weights,
                                         input_shape=(IN_DIM,)),
             jax_flattener(input_shape=(OUT_DIM,))])
        assert composed.input_names == ref.input_names == ["input"]
        assert composed.output_names == ref.output_names == ["flattened"]
        assert_close(composed(x_batch), ref(x_batch))
        assert_close(composed(x_batch), expected)

    def test_from_list_rejects_multi_io_chain(self):
        """A two-output stage before another is refused when the chain
        runs, with the JAX package's message."""
        from sparkdl_tpu.graph import ModelFunction as JaxModelFunction
        from sparkdl_tpu.graph import buildFlattener as jax_flattener

        class TwoOut(torch.nn.Module):
            def forward(self, inputs):
                x = inputs["input"]
                return {"a": x, "b": x}

        multi = ModelFunction(TwoOut(), {"input": ((IN_DIM,), np.float32)},
                              device="cpu")
        assert multi.output_names == ["a", "b"]
        composed = ModelFunction.fromList(
            [multi, buildFlattener(input_shape=(IN_DIM,), device="cpu")])
        ref = JaxModelFunction.fromList(
            [JaxModelFunction(lambda p, i: {"a": i["input"],
                                            "b": i["input"]}, None,
                              {"input": ((IN_DIM,), np.float32)}),
             jax_flattener(input_shape=(IN_DIM,))])
        x = np.zeros((2, IN_DIM), np.float32)
        with pytest.raises(ValueError) as ref_err:
            ref(x)
        with pytest.raises(ValueError) as err:
            composed(x)
        assert str(err.value) == str(ref_err.value)
        assert "fromList chains single-output stages" in str(err.value)

    def test_from_list_rejects_functions_on_two_devices(self, mlp_weights):
        mf = port_single(mlp_weights)
        other = port_single(mlp_weights)
        other.device = torch.device("meta")
        with pytest.raises(ValueError, match="on one device"):
            ModelFunction.fromList([mf, other])

    def test_rename_io(self, mlp_weights, x_batch, jax_single):
        mf = port_single(mlp_weights).rename_io({"input": "features"},
                                                {"output": "logits"})
        ref = jax_single.rename_io({"input": "features"},
                                   {"output": "logits"})
        assert mf.input_names == ref.input_names == ["features"]
        assert mf.output_names == ref.output_names == ["logits"]
        assert_close(mf({"features": x_batch})["logits"],
                     ref({"features": x_batch})["logits"])

    @pytest.mark.parametrize("order,scale,offset", [
        ("RGB", 1 / 127.5, -1.0), ("BGR", 1.0, 0.0), ("BGR", 0.5, 3.0)])
    def test_image_converter_piece(self, order, scale, offset):
        from sparkdl_tpu.graph import buildSpImageConverter as jax_conv
        x = np.random.default_rng(3).integers(0, 256, (2, 5, 4, 3),
                                              dtype=np.uint8)
        conv = buildSpImageConverter(5, 4, 3, channel_order=order,
                                     scale=scale, offset=offset,
                                     device="cpu")
        out = conv(x)
        ref = np.asarray(jax_conv(5, 4, 3, channel_order=order, scale=scale,
                                  offset=offset)(x))
        assert out.dtype == np.float32 and out.shape == (2, 5, 4, 3)
        assert conv.input_signature == {"image": ((5, 4, 3), np.uint8)}
        assert conv.output_names == ["converted"]
        assert_close(out, ref)
        if order == "BGR":
            np.testing.assert_array_equal(
                out[..., 0], (x[..., 2] * np.float32(scale)
                              + np.float32(offset)).astype(np.float32))

    def test_image_converter_refuses_unknown_order(self):
        with pytest.raises(ValueError, match="RGB or BGR"):
            buildSpImageConverter(2, 2, channel_order="RBG", device="cpu")

    def test_flattener(self):
        from sparkdl_tpu.graph import buildFlattener as jax_flattener
        x = np.random.default_rng(4).integers(0, 9, (3, 2, 3, 2)) \
            .astype(np.int32)
        out = buildFlattener((2, 3, 2), device="cpu")(x)
        ref = np.asarray(jax_flattener((2, 3, 2))(x))
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out, ref)


class TestIngestionMatrix:
    """Every source gives the JAX package's outputs (the reference's
    ``test_input.py`` conformance pattern)."""

    def test_from_function(self, mlp_weights, x_batch, expected):
        mf = ModelIngest.fromFunction(torch_mlp, mlp_weights,
                                      input_shape=(IN_DIM,), device="cpu")
        assert_close(mf(x_batch), expected)
        # the dict form: fn(params, inputs) -> outputs
        mf2 = ModelIngest.fromFunction(
            lambda p, i: {"y": torch_mlp(p, i["x"])}, mlp_weights,
            input_signature={"x": ((IN_DIM,), np.float32)}, device="cpu")
        assert mf2.output_names == ["y"]
        assert_close(mf2({"x": x_batch})["y"], expected)

    def test_from_export_roundtrip(self, mlp_weights, x_batch, expected):
        """A symbolic batch: any batch of 1 to MAX_EXPORT_BATCH rows, the
        signatures read from the program."""
        from sparkdl_tpu.graph import ModelIngest as JaxModelIngest
        mf = ModelIngest.fromFunction(torch_mlp, mlp_weights,
                                      input_shape=(IN_DIM,), device="cpu")
        mf2 = ModelIngest.fromExport(mf.export(batch_size=None),
                                     device="cpu")
        ref = JaxModelIngest.fromExport(JaxModelIngest.fromFunction(
            jax_mlp, mlp_weights, input_shape=(IN_DIM,)).export())
        assert mf2.input_signature == {"input": ((IN_DIM,),
                                                 np.dtype(np.float32))}
        assert mf2.input_signature["input"][0] == \
            ref.input_signature["input"][0]
        assert mf2._fixed_batch is None and ref._fixed_batch is None
        assert mf2.output_signature() == {"output": (
            (OUT_DIM,), np.dtype(np.float32))}
        out = mf2(x_batch)
        np.testing.assert_array_equal(out, mf(x_batch))
        assert_close(out, expected)
        np.testing.assert_array_equal(mf2(x_batch[:1]), mf(x_batch[:1]))

    def test_from_export_fixed_batch(self, mlp_weights, x_batch, expected):
        from sparkdl_tpu.graph import ModelIngest as JaxModelIngest
        mf = ModelIngest.fromFunction(torch_mlp, mlp_weights,
                                      input_shape=(IN_DIM,), device="cpu")
        mf2 = ModelIngest.fromExport(mf.export(batch_size=6), device="cpu")
        ref = JaxModelIngest.fromExport(JaxModelIngest.fromFunction(
            jax_mlp, mlp_weights, input_shape=(IN_DIM,)).export(6))
        assert mf2._fixed_batch == ref._fixed_batch == 6
        assert_close(mf2(x_batch), expected)
        with pytest.raises(ValueError, match="fixed batch of 6"):
            mf2(x_batch[:5])

    def test_fixed_batch_survives_wrappers(self, mlp_weights, x_batch,
                                           expected):
        """Wrappers over a fixed-batch program keep its batch: their
        traces run at 6 rows, which the program takes."""
        mf = ModelIngest.fromFunction(torch_mlp, mlp_weights,
                                      input_shape=(IN_DIM,), device="cpu")
        frozen = ModelIngest.fromExport(mf.export(batch_size=6),
                                        device="cpu")

        post = tfx.with_postprocessor(frozen,
                                      lambda o: {"y2": o["output"] * 2})
        assert post.output_names == ["y2"]   # traced at batch 6, not 1
        assert post._fixed_batch == 6
        assert_close(post({"input": x_batch})["y2"], expected * 2)

        sel = tfx.select_outputs(frozen, ["output"])
        assert sel.output_signature()["output"][0] == (OUT_DIM,)
        assert sel._fixed_batch == 6

        renamed = frozen.rename_io(output_map={"output": "z"})
        assert renamed.output_signature()["z"][0] == (OUT_DIM,)
        assert renamed._fixed_batch == 6

        pre = tfx.with_preprocessor(frozen, lambda i: i)
        assert pre._fixed_batch == 6
        assert pre.output_signature() == frozen.output_signature()
        chained = ModelFunction.fromList(
            [frozen, buildFlattener((OUT_DIM,), input_name="flat",
                                    device="cpu")])
        assert chained._fixed_batch == 6
        assert chained.output_signature()["flattened"][0] == (OUT_DIM,)
        # and re-export keeps it
        again = ModelFunction.deserialize(renamed.export(6), device="cpu")
        assert again._fixed_batch == 6
        np.testing.assert_array_equal(again({"input": x_batch})["z"],
                                      frozen(x_batch))
        with pytest.raises(ValueError, match="fixed batch of 6"):
            renamed.export()

    def test_not_an_export_is_refused(self):
        with pytest.raises(ValueError, match="not a torch.export program"):
            ModelIngest.fromExport(b"definitely not a program", device="cpu")

    def test_pickle_ships_the_export(self, mlp_weights, x_batch):
        import pickle
        mf = port_single(mlp_weights)
        back = pickle.loads(pickle.dumps(mf))
        assert back.input_signature == mf.input_signature
        assert back.device == torch.device("cpu")
        np.testing.assert_array_equal(back(x_batch), mf(x_batch))

    def test_graph_utils(self, mlp_weights, jax_single):
        from sparkdl_tpu.graph import utils as jax_tfx
        mf = port_single(mlp_weights)
        assert tfx.validated_model(mf) is mf
        assert tfx.input_names(mf) == jax_tfx.input_names(jax_single)
        assert tfx.output_names(mf) == jax_tfx.output_names(jax_single)
        assert tfx.get_input_shape(mf, "input") == \
            jax_tfx.get_input_shape(jax_single, "input") == (IN_DIM,)
        assert tfx.get_output_shape(mf, "output") == \
            jax_tfx.get_output_shape(jax_single, "output") == (OUT_DIM,)
        with pytest.raises(ValueError, match="not in model"):
            tfx.validated_input(mf, "nope")
        with pytest.raises(ValueError, match="not in model"):
            tfx.validated_output(mf, "nope")
        with pytest.raises(TypeError, match="expected a ModelFunction"):
            tfx.validated_model(object())
        frozen = tfx.load_frozen(tfx.strip_and_freeze(mf), device="cpu")
        x = np.ones((2, IN_DIM), np.float32)
        np.testing.assert_array_equal(frozen(x), mf(x))

    def _keras_model(self, mlp_weights):
        import keras
        m = keras.Sequential([
            keras.layers.Input((IN_DIM,)),
            keras.layers.Dense(HID, activation="relu"),
            keras.layers.Dense(OUT_DIM),
        ])
        m.set_weights([mlp_weights["W1"], mlp_weights["b1"],
                       mlp_weights["W2"], mlp_weights["b2"]])
        return m

    def test_from_keras_model(self, mlp_weights, x_batch, expected):
        from sparkdl_tpu.graph import ModelIngest as JaxModelIngest
        model = self._keras_model(mlp_weights)
        mf = ModelIngest.fromKerasModel(model, device="cpu")
        ref = JaxModelIngest.fromKerasModel(model)
        assert mf.input_signature == {"input": ((IN_DIM,),
                                                np.dtype(np.float32))}
        assert mf.output_names == ref.output_names == ["output_0"]
        assert_close(mf(x_batch), ref(x_batch))
        assert_close(mf(x_batch), expected)

    @pytest.mark.parametrize("ext", ["h5", "keras"])
    def test_from_keras_file(self, mlp_weights, x_batch, expected,
                             tmp_path, ext):
        from sparkdl_tpu.graph import ModelIngest as JaxModelIngest
        path = str(tmp_path / f"model.{ext}")
        self._keras_model(mlp_weights).save(path)
        mf = ModelIngest.fromKerasFile(path, device="cpu")
        assert_close(mf(x_batch), JaxModelIngest.fromKerasFile(path)(x_batch))
        assert_close(mf(x_batch), expected)

    def test_alias(self):
        assert TFInputGraph is ModelIngest


# -- K1 and K2 as registered ops ---------------------------------------------

@pytest.mark.parametrize("dtype,shape,out_hw,scale,offset", [
    (torch.uint8, (2, 9, 7, 3), (5, 6), 1.0, 0.0),
    (torch.float32, (1, 6, 10, 1), (12, 4), 0.5, -1.0)])
def test_opcheck_resize_normalize(dtype, shape, out_hw, scale, offset):
    """The registered K1 op passes ``torch.library.opcheck`` on the CPU:
    its schema, its fake (the output's shape and dtype, no data), and
    its use under AOT tracing with a dynamic batch."""
    x = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, shape).astype(np.uint8)).to(dtype)
    torch.library.opcheck(torch.ops.sparkdl_tpu_torch.resize_normalize,
                          (x, *out_hw, scale, offset))


@pytest.mark.parametrize("src_hw,out_hw,out_dtype", [
    ((6, 8), (5, 7), torch.uint8), ((4, 4), (9, 9), torch.float32)])
def test_opcheck_yuv420_resize_normalize(src_hw, out_hw, out_dtype):
    n = src_hw[0] * src_hw[1] * 3 // 2
    x = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, n)).astype(np.uint8))
    torch.library.opcheck(
        torch.ops.sparkdl_tpu_torch.yuv420_resize_normalize,
        (x, *src_hw, *out_hw, 1.0, 0.0, out_dtype))


@pytest.fixture
def testnet(tmp_path, monkeypatch):
    """The committed TestNet on the CPU (an empty weight cache)."""
    monkeypatch.setenv("SPARKDL_TPU_TORCH_MODEL_CACHE", str(tmp_path))
    from sparkdl_tpu_torch.models import zoo
    return zoo.getModelFunction("TestNet", device="cpu")


def _count_plain(monkeypatch):
    """Count the calls of both ops' CPU implementations (their plain
    versions), which the registered ops look up by name."""
    from sparkdl_tpu_torch.ops import infeed
    calls = {"rgb": 0, "yuv420": 0}
    plain = infeed.fused_resize_normalize_plain
    plain420 = infeed.fused_yuv420_resize_normalize_plain

    def counted(*a, **k):
        calls["rgb"] += 1
        return plain(*a, **k)

    def counted420(*a, **k):
        calls["yuv420"] += 1
        return plain420(*a, **k)

    monkeypatch.setattr(infeed, "fused_resize_normalize_plain", counted)
    monkeypatch.setattr(infeed, "fused_yuv420_resize_normalize_plain",
                        counted420)
    return calls


@pytest.mark.parametrize("fmt,op", [
    ("rgb", "resize_normalize"), ("yuv420", "yuv420_resize_normalize")])
def test_device_resize_model_exports_with_its_op(testnet, monkeypatch,
                                                 fmt, op):
    """``deviceResizeModel(TestNet, (40, 40))`` and its 4:2:0 twin,
    exported with a symbolic batch and reloaded: the program's graph
    calls the registered op, the output has the same bits, and neither
    ``output_signature`` nor the export runs the op's implementation
    (its fake gives the shapes), so on the card no kernel would
    launch."""
    from sparkdl_tpu_torch.ops import infeed
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    mf = deviceResizeModel(testnet, (40, 40), packedFormat=fmt)
    calls = _count_plain(monkeypatch)
    before = (infeed.launches, infeed.yuv420_launches)
    assert mf.output_signature() == {"features": ((16,),
                                                  np.dtype(np.float32))}
    blob = mf.export()
    assert calls == {"rgb": 0, "yuv420": 0}
    back = ModelFunction.deserialize(blob, device="cpu")
    assert back.output_signature() == mf.output_signature()
    assert calls == {"rgb": 0, "yuv420": 0}
    assert (infeed.launches, infeed.yuv420_launches) == before
    targets = [str(n.target) for n in back.module.program.graph.nodes
               if n.op == "call_function"]
    assert f"sparkdl_tpu_torch.{op}.default" in targets
    shape, _ = mf.input_signature["image"]
    x = np.random.default_rng(7).integers(0, 256, (5,) + shape,
                                          dtype=np.uint8)
    got = back({"image": x})["features"]
    assert calls[fmt] == 1
    np.testing.assert_array_equal(got, mf({"image": x})["features"])
    fixed = ModelFunction.deserialize(mf.export(batch_size=5),
                                      device="cpu")
    np.testing.assert_array_equal(fixed({"image": x})["features"], got)


def test_runner_empty_outputs_run_no_model(testnet, monkeypatch):
    """An empty partition's outputs take their shapes from the output
    signature: the model does not run (the JAX runner's ``eval_shape``),
    so on the card the resize kernel does not launch."""
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    mf = deviceResizeModel(testnet, (40, 40))
    calls = _count_plain(monkeypatch)
    out = BatchRunner(mf, batch_size=4).run(
        {"image": np.zeros((0, 40, 40, 3), np.uint8)})
    assert out["features"].shape == (0, 16)
    assert out["features"].dtype == np.float32
    assert calls == {"rgb": 0, "yuv420": 0}
