"""The port's first slice end to end on the CPU: ``readImages`` →
``DeepImageFeaturizer(deviceResizeFrom=...)`` through both packages on the
same files and the same (committed TestNet) weights; the port's import
closure; its refusal to run on the CPU unasked; and the runner and frame
pieces the slice rests on."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# TestNet runs in float32 on both sides, through the same resize math,
# so the features differ by the order of float32 sums: 1e-5 of their
# largest magnitude. The exception is an image where the two resizes
# round a pixel that sits at a tie (k + 0.5 up to float32 summation
# order) to neighbouring uint8 counts (test_device_resize_rounds_like_jax):
# a 1/255 step at a few of its 1024 input pixels, which moves its
# features by at most TOL_FEATURES_TIE of the largest magnitude.
TOL_FEATURES = 1e-5
TOL_FEATURES_TIE = 2e-3
# a float32 resize value this close to k + 0.5 is a tie
TIE = 1e-4


def resize_round_both(x, out_hw):
    """(port uint8, JAX uint8, port float32) resize of NHWC uint8 ``x``,
    each rounded half to even as the featurizer does."""
    import jax.numpy as jnp
    from sparkdl_tpu.ops import fused_resize_normalize as jax_resize
    from sparkdl_tpu_torch.ops import fused_resize_normalize
    from sparkdl_tpu_torch.transformers.utils import round_to_uint8
    y = fused_resize_normalize(torch.from_numpy(x), out_hw)
    ref = jnp.clip(jnp.round(jax_resize(x, out_hw)), 0, 255)
    return (round_to_uint8(y).numpy(), np.asarray(ref.astype(jnp.uint8)),
            y.numpy())


@pytest.fixture(scope="module")
def png_dir(tmp_path_factory):
    """Uniform 40×56 PNGs (lossless, so both decoders agree) plus one
    file that fails to decode."""
    from PIL import Image
    d = tmp_path_factory.mktemp("torch_slice_pngs")
    rng = np.random.default_rng(7)
    for i in range(10):
        arr = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
        Image.fromarray(arr, "RGB").save(d / f"img_{i:02d}.png")
    (d / "broken.png").write_bytes(b"not an image")
    return str(d)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    """An empty JAX weight cache (so JAX loads its committed TestNet) and
    a port cache seeded with those weights through the bridge."""
    from sparkdl_tpu.models import zoo as jax_zoo
    from sparkdl_tpu.models.fetcher import ModelFetcher as JaxFetcher
    from sparkdl_tpu_torch.models.convert import flax_to_state_dict
    from sparkdl_tpu_torch.models.fetcher import ModelFetcher
    jax_dir = str(tmp_path_factory.mktemp("jax_cache"))
    torch_dir = str(tmp_path_factory.mktemp("torch_cache"))
    variables = jax_zoo.load_variables("TestNet", JaxFetcher(jax_dir))
    ModelFetcher(torch_dir).put("TestNet.pt", flax_to_state_dict(variables))
    return jax_dir, torch_dir


@pytest.fixture
def cache_env(caches, monkeypatch):
    jax_dir, torch_dir = caches
    monkeypatch.setenv("SPARKDL_TPU_MODEL_CACHE", jax_dir)
    monkeypatch.setenv("SPARKDL_TPU_TORCH_MODEL_CACHE", torch_dir)


def test_featurizer_matches_jax_end_to_end(png_dir, cache_env):
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu.data.tensors import arrow_to_tensor
    from sparkdl_tpu.models import zoo as jax_zoo
    from sparkdl_tpu_torch.models import zoo

    assert jax_zoo.weights_provenance("TestNet") == "committed"
    assert zoo.weights_provenance("TestNet") == "cache"
    kw = dict(inputCol="image", outputCol="features", modelName="TestNet",
              deviceResizeFrom=(40, 56), batchSize=4)

    ref_table = sparkdl_tpu.DeepImageFeaturizer(**kw).transform(
        sparkdl_tpu.readImages(png_dir, numPartitions=3)).collect()
    ref_paths = ref_table.column("filePath").to_pylist()
    idx = ref_table.schema.get_field_index("features")
    ref = arrow_to_tensor(ref_table.column(idx), ref_table.schema.field(idx))

    featurizer = sparkdl_tpu_torch.DeepImageFeaturizer(device="cpu", **kw)
    out = featurizer.transform(
        sparkdl_tpu_torch.readImages(png_dir, numPartitions=3)).collect()
    assert list(out["filePath"]) == ref_paths
    assert len(ref_paths) == 10 and not any("broken" in p for p in ref_paths)
    assert out["features"].shape == ref.shape == (10, 16)
    assert out["features"].dtype == np.float32
    from PIL import Image
    x = np.stack([np.asarray(Image.open(p)) for p in ref_paths])
    got_u8, ref_u8, _ = resize_round_both(x, (32, 32))
    tie_rows = (got_u8 != ref_u8).any(axis=(1, 2, 3))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out["features"][~tie_rows], ref[~tie_rows],
                               rtol=0, atol=TOL_FEATURES * scale)
    np.testing.assert_allclose(out["features"], ref, rtol=0,
                               atol=TOL_FEATURES_TIE * scale)
    assert featurizer.metrics.rows == 10
    assert featurizer.metrics.batches == 3  # partitions of 4, 3, 3 rows


def test_device_resize_rounds_like_jax():
    """The resize + round-half-even cast the featurizer puts before the
    model gives the JAX package's uint8 image, except at ties: there the
    two float32 sums may land on either side of k + 0.5, and the counts
    differ by one."""
    from sparkdl_tpu_torch.transformers.utils import round_to_uint8
    x = np.random.default_rng(8).integers(0, 256, (6, 40, 56, 3),
                                          dtype=np.uint8)
    got, ref, y = resize_round_both(x, (32, 32))
    diff = got.astype(int) - ref.astype(int)
    assert np.abs(diff).max() <= 1
    assert (np.abs(np.abs(y - np.floor(y)) - 0.5)[diff != 0] < TIE).all()
    assert (diff != 0).mean() < 1e-3
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5, 254.5, 255.5, 300.0])
    assert round_to_uint8(halves).tolist() == [0, 2, 2, 0, 254, 255, 255]


def test_import_closure_and_chip_smoke_without_cuda():
    """Importing the port and every submodule (the zoo's models, the
    msgpack reader, the resilience package, the engine and the runner,
    the estimators, tuning and persistence, the metrics registry, the
    host pipeline and the input service, the serve layer, the SLO
    tracker and the request log, the span tracer, the report and its
    ``python -m`` entry, the watchdog, the flight recorder and the
    telemetry surface among them), chip_smoke.py
    and k2_phases.py, loads none of jax, flax, optax, sparkdl_tpu,
    pyarrow, PIL, msgpack, cloudpickle, keras or tensorflow (the graph
    toolkit, the Keras converter and transformers, the UDFs, the Keras
    weight import and the Keras estimator among the modules); without CUDA chip_smoke.py and k2_phases.py
    exit non-zero and print nothing on stdout; and a spawned host
    pipeline worker and a ``DecodeServer`` subprocess, each running a
    probe stage that returns its ``sorted(sys.modules)``, load none of
    them either."""
    code = (
        "import contextlib, importlib, io, json, pkgutil, runpy, sys\n"
        "import sparkdl_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    sparkdl_tpu_torch.__path__, 'sparkdl_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "exports = sorted(n for n in ('readImagesPacked', 'TensorTransformer',\n"
        "                             'DataFrame', 'DeepImagePredictor',\n"
        "                             'LogisticRegression', 'Pipeline',\n"
        "                             'CrossValidator', 'TrainValidationSplit',\n"
        "                             'ParamGridBuilder', 'load_model',\n"
        "                             'ClassificationEvaluator',\n"
        "                             'BinaryClassificationEvaluator',\n"
        "                             'LossEvaluator', 'KerasTransformer',\n"
        "                             'KerasImageFileTransformer',\n"
        "                             'TFImageTransformer', 'TFTransformer',\n"
        "                             'TFInputGraph', 'ModelIngest',\n"
        "                             'registerKerasImageUDF',\n"
        "                             'KerasImageFileEstimator')\n"
        "                 if callable(getattr(sparkdl_tpu_torch, n)))\n"
        "smoke = runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "sys.path.insert(0, '.')\n"
        "phases = runpy.run_path('k2_phases.py', run_name='k2_phases')\n"
        "banned = ('jax', 'flax', 'optax', 'sparkdl_tpu', 'pyarrow', "
        "'PIL', 'msgpack', 'cloudpickle', 'keras', 'tensorflow')\n"
        "loaded = sorted(n for n in sys.modules\n"
        "                if n.split('.')[0] in banned)\n"
        "out = io.StringIO()\n"
        "with contextlib.redirect_stdout(out):\n"
        "    rc = smoke['main']()\n"
        "    rc_phases = phases['main']()\n"
        # a probe stage in a module of its own, importable by a spawned
        # pool worker (which gets this sys.path) and a DecodeServer
        # subprocess (PYTHONPATH)
        "import os, queue, subprocess, tempfile, threading\n"
        "import numpy as np\n"
        "d = tempfile.mkdtemp()\n"
        "with open(os.path.join(d, 'closure_probe.py'), 'w') as f:\n"
        "    f.write('import os, sys\\nimport numpy as np\\n'\n"
        "            'def probe(batch):\\n'\n"
        "            '    mods = np.empty(1, dtype=object)\\n'\n"
        "            '    mods[0] = [os.getpid()] + sorted(sys.modules)\\n'\n"
        "            '    return {\"mods\": mods}\\n')\n"
        "sys.path.insert(0, d)\n"
        "import closure_probe\n"
        "from sparkdl_tpu_torch.data.engine import LocalEngine\n"
        "from sparkdl_tpu_torch.data.frame import DataFrame\n"
        "def probe_mods(engine):\n"
        "    df = DataFrame.from_columns({'i': np.arange(2)}, 2, engine)\n"
        "    try:\n"
        "        return list(df.map_batches(closure_probe.probe)\n"
        "                    .collect()['mods'][0])\n"
        "    finally:\n"
        "        engine.shutdown()\n"
        "worker = probe_mods(LocalEngine(pipeline_workers=2,\n"
        "                                pipeline_mode='process'))\n"
        "env = dict(os.environ, PYTHONPATH=os.pathsep.join(\n"
        "    [os.getcwd(), d]))\n"
        "srv = subprocess.Popen([sys.executable, '-m',\n"
        "                        'sparkdl_tpu_torch.inputsvc', 'serve'],\n"
        "                       stdout=subprocess.PIPE, text=True, env=env)\n"
        "try:\n"
        "    lines = queue.Queue()\n"
        "    threading.Thread(target=lambda: [lines.put(x) for x in\n"
        "                     srv.stdout], daemon=True).start()\n"
        "    endpoint = lines.get(timeout=60).split()[-1]\n"
        "    server = probe_mods(LocalEngine(inputsvc_endpoints=endpoint))\n"
        "finally:\n"
        "    srv.terminate()\n"
        "    srv.wait(timeout=15)\n"
        "probes = {'worker': worker, 'server': server}\n"
        "print(json.dumps({'mods': mods, 'loaded': loaded, 'rc': rc,\n"
        "                  'rc_phases': rc_phases, 'exports': exports,\n"
        "                  'smoke_stdout': out.getvalue(), 'probes': probes,\n"
        "                  'pid': os.getpid(), 'srv_pid': srv.pid}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    banned = ("jax", "flax", "optax", "sparkdl_tpu", "pyarrow", "PIL",
              "msgpack", "cloudpickle", "keras", "tensorflow")
    for mod in ("transformers.named_image", "transformers.tensor_transform",
                "native", "image.imageIO", "models.msgpack", "models.resnet",
                "models.xception", "models.vgg", "models.zoo",
                "resilience", "resilience.errors", "resilience.policy",
                "resilience.faults", "data.engine", "data.frame",
                "runtime.runner", "params.pipeline", "params.tuning",
                "params.persistence", "estimators.logistic_regression",
                "estimators.evaluators", "obs", "obs.registry",
                "data.pipeline", "data.codec", "inputsvc",
                "inputsvc.transport", "inputsvc.server", "inputsvc.client",
                "inputsvc.snapshot", "inputsvc.__main__", "graph",
                "graph.function", "graph.utils", "graph.pieces",
                "graph.ingest", "graph.keras_convert", "params.image",
                "transformers.keras_tensor", "transformers.keras_image",
                "udf", "udf.registry", "udf.keras_image_model",
                "models.import_keras", "obs.trace", "obs.report",
                "obs.__main__", "obs.watchdog", "obs.flight", "obs.export",
                "runtime.sanitize", "estimators",
                "estimators.keras_image_file_estimator", "params.shared",
                "parallel.train"):
        assert f"sparkdl_tpu_torch.{mod}" in result["mods"]
    assert result["exports"] == sorted([
        "DataFrame", "DeepImagePredictor", "TensorTransformer",
        "readImagesPacked", "LogisticRegression", "Pipeline",
        "CrossValidator", "TrainValidationSplit", "ParamGridBuilder",
        "load_model", "ClassificationEvaluator",
        "BinaryClassificationEvaluator", "LossEvaluator", "KerasTransformer",
        "KerasImageFileTransformer", "TFImageTransformer", "TFTransformer",
        "TFInputGraph", "ModelIngest", "registerKerasImageUDF",
        "KerasImageFileEstimator"])
    assert result["loaded"] == []
    assert result["rc"] != 0 and result["rc_phases"] != 0
    assert result["smoke_stdout"] == ""
    probes = result["probes"]
    assert probes["worker"][0] not in (result["pid"], result["srv_pid"])
    assert probes["server"][0] == result["srv_pid"]
    for where, mods in probes.items():
        assert "sparkdl_tpu_torch.data.pipeline" in mods[1:], where
        assert [m for m in mods[1:] if m.split(".")[0] in banned] == [], \
            where


def test_drain_ab_without_cuda(tmp_path):
    """Without CUDA drain_ab.py exits non-zero, prints nothing on stdout
    and writes no result (its child stops before any measurement)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "drain_ab.py"), "--tree",
         f"change={REPO}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == "", proc.stdout
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "chiprun_out").exists()


def test_default_device_raises_without_cuda(png_dir):
    """``device=None`` means the card: with no CUDA every entry point
    raises instead of running on the CPU."""
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch._device import resolve_device
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import zoo
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        zoo.getModelFunction("TestNet")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelFunction(torch.nn.Identity(), {"x": ((1,), np.float32)},
                      ["x"])
    df = sparkdl_tpu_torch.readImages(png_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sparkdl_tpu_torch.DeepImageFeaturizer(
            inputCol="image", outputCol="f", modelName="TestNet",
            deviceResizeFrom=(40, 56)).transform(df)
    assert resolve_device("cpu") == torch.device("cpu")


class _Double(torch.nn.Module):
    def forward(self, inputs):
        return {"y": inputs["x"].to(torch.float32) * 2}


@pytest.mark.parametrize("n,batch", [(10, 4), (8, 4), (3, 8)])
def test_runner_pads_and_slabs(n, batch):
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    mf = ModelFunction(_Double(), {"x": ((2, 3), np.uint8)}, ["y"],
                       device="cpu")
    runner = BatchRunner(mf, batch_size=batch)
    x = np.arange(n * 6, dtype=np.uint8).reshape(n, 2, 3)
    out = runner.run({"x": x})["y"]
    np.testing.assert_array_equal(out, x.astype(np.float32) * 2)
    assert runner.metrics.rows == n
    assert runner.metrics.batches == -(-n // batch)
    # on the CPU only the padded tail is staged, as the JAX runner counts
    assert runner.metrics.bytes_staged == x[:n % batch].nbytes
    assert runner.run({"x": x[:0]})["y"].shape == (0, 2, 3)
    with pytest.raises(ValueError, match="expects"):
        runner.run({"x": np.zeros((2, 3, 3), np.uint8)})


def test_frame_filter_collect_and_tensor():
    from sparkdl_tpu_torch import DataFrame
    rows = [{"name": f"r{i}", "v": i, "t": np.full(3, i, np.float32)}
            for i in range(7)]
    df = DataFrame.from_pylist(rows, num_partitions=3)
    assert df.num_partitions == 3 and df.count() == 7
    assert df.columns == ["name", "v", "t"]
    odd = df.filter(lambda b: b["v"] % 2 == 1)
    assert odd.count() == 3
    assert [r["name"] for r in odd.collect_rows()] == ["r1", "r3", "r5"]
    np.testing.assert_array_equal(df.tensor("t")[:, 0], np.arange(7))
    doubled = df.map_batches(lambda b: {**b, "v": b["v"] * 2})
    assert list(doubled.collect()["v"]) == [2 * i for i in range(7)]


def test_image_struct_round_trip():
    from sparkdl_tpu.image import imageIO as jax_io
    from sparkdl_tpu_torch.image import imageIO
    arr = np.random.default_rng(9).integers(0, 256, (5, 7, 3),
                                            dtype=np.uint8)
    s = imageIO.imageArrayToStruct(arr, origin="a.png")
    assert s == jax_io.imageArrayToStruct(arr, origin="a.png")
    np.testing.assert_array_equal(imageIO.imageStructToArray(s), arr)
    gray = imageIO.imageArrayToStruct(arr[:, :, 0])
    assert (gray["nChannels"], gray["mode"]) == (1, 0)


def test_pack_refuses_off_size_rows():
    """``resize=False`` refuses an off-size row by its index; rows at
    the size pack as they are."""
    from sparkdl_tpu_torch.data.frame import to_column
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.transformers.utils import packImageBatch
    col = to_column([imageArrayToStruct(np.zeros((4, 4, 3), np.uint8)),
                     imageArrayToStruct(np.zeros((5, 4, 3), np.uint8))])
    assert packImageBatch(col[:1], 4, 4).shape == (1, 4, 4, 3)
    with pytest.raises(ValueError, match="row 1"):
        packImageBatch(col, 4, 4, resize=False)


@pytest.mark.parametrize("path", ["native", "pil"])
def test_pack_resizes_off_size_rows_like_jax(path, monkeypatch):
    """Mixed-size rows (and a gray and an RGBA row) resize on the host to
    the JAX package's bytes: through the same C++ shim source on both
    sides, or through PIL on both when neither has the shim."""
    import sparkdl_tpu.image.imageIO as jax_io
    from sparkdl_tpu.transformers.utils import packImageBatch as jax_pack
    from sparkdl_tpu_torch import native
    from sparkdl_tpu_torch.data.frame import to_column
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.transformers.utils import packImageBatch
    if path == "pil":
        monkeypatch.setattr(native, "resize_pack_batch",
                            lambda *a, **k: None)
        monkeypatch.setenv("SPARKDL_TPU_NO_NATIVE", "1")
    rng = np.random.default_rng(11)
    arrays = [rng.integers(0, 256, shape, dtype=np.uint8) for shape in (
        (12, 16, 3), (30, 41, 3), (7, 9, 3), (12, 16, 1), (25, 20, 4))]
    structs = [imageArrayToStruct(a, origin=f"r{i}")
               for i, a in enumerate(arrays)]
    got = packImageBatch(to_column(structs), 12, 16)
    ref = jax_pack(jax_io.structsToBatch(structs).column(0), 12, 16)
    assert got.shape == (5, 12, 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], arrays[0])


class _MeanPixel(torch.nn.Module):
    def forward(self, inputs):
        return {"m": inputs["img"].to(torch.float32).mean(dim=(1, 2))}


def test_image_transformer_float_input_model_with_device_resize():
    """A user model declaring float32 input: the host packs uint8 as
    float32 and the device resize output is handed over unrounded."""
    from sparkdl_tpu_torch import DataFrame, ImageTransformer
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.ops import fused_resize_normalize
    imgs = np.random.default_rng(10).integers(0, 256, (5, 12, 10, 3),
                                              dtype=np.uint8)
    df = DataFrame.from_pylist(
        [{"image": imageArrayToStruct(a)} for a in imgs], num_partitions=2)
    mf = ModelFunction(_MeanPixel(), {"img": ((6, 4, 3), np.float32)},
                       ["m"], device="cpu")
    out = ImageTransformer(inputCol="image", outputCol="m",
                           modelFunction=mf, batchSize=2,
                           deviceResizeFrom=(12, 10)).transform(df)
    got = out.tensor("m")
    ref = fused_resize_normalize(torch.from_numpy(imgs).float(), (6, 4))
    np.testing.assert_allclose(got, ref.mean(dim=(1, 2)).numpy(),
                               rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------------
# The 4:2:0 headline slice: readImagesPacked(yuv420) →
# deviceResizeModel(yuv420) → TensorTransformer, with TestNet
# ---------------------------------------------------------------------------

YUV_SRC = (24, 24)


@pytest.fixture(scope="module")
def jpeg_dir(tmp_path_factory):
    """JPEGs of a few sizes, all read at YUV_SRC, and one corrupt file."""
    from PIL import Image
    d = tmp_path_factory.mktemp("torch_slice_jpegs")
    rng = np.random.default_rng(31)
    for i in range(9):
        h, w = (48, 48) if i % 3 else (37, 60)
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr, "RGB").save(d / f"img_{i:02d}.jpg")
    (d / "broken.jpg").write_bytes(b"\xff\xd8\xff not a jpeg")
    return str(d)


def test_yuv420_slice_matches_jax_end_to_end(jpeg_dir, cache_env):
    """The same JPEGs through both packages' readers (byte-equal rows),
    then TensorTransformer over deviceResizeModel(TestNet, 4:2:0), with
    the same weights; the port's device op fuses the round to uint8."""
    import sparkdl_tpu_torch
    from sparkdl_tpu.data.tensors import arrow_to_tensor
    from sparkdl_tpu.image import imageIO as jax_io
    from sparkdl_tpu.models import zoo as jax_zoo
    from sparkdl_tpu.ops import fused_yuv420_resize_normalize as jax_yuv
    from sparkdl_tpu.transformers.tensor_transform import (
        TensorTransformer as JaxTensorTransformer,
    )
    from sparkdl_tpu.transformers.utils import (
        deviceResizeModel as jax_device_resize,
    )
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.ops import fused_yuv420_resize_normalize
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel

    kw = dict(inputMapping={"image": "image"},
              outputMapping={"features": "features"}, batchSize=4)
    jax_mf = jax_device_resize(jax_zoo.getModelFunction("TestNet"),
                               YUV_SRC, packedFormat="yuv420")
    table = JaxTensorTransformer(modelFunction=jax_mf, **kw).transform(
        jax_io.readImagesPacked(jpeg_dir, YUV_SRC, numPartitions=3,
                                packedFormat="yuv420")).collect()
    idx = table.schema.get_field_index("features")
    ref = arrow_to_tensor(table.column(idx), table.schema.field(idx))
    idx = table.schema.get_field_index("image")
    packed = arrow_to_tensor(table.column(idx), table.schema.field(idx))

    mf = deviceResizeModel(zoo.getModelFunction("TestNet", device="cpu"),
                           YUV_SRC, packedFormat="yuv420")
    assert mf.input_signature == {"image": ((864,), np.uint8)}
    transformer = sparkdl_tpu_torch.TensorTransformer(modelFunction=mf,
                                                      **kw)
    df = sparkdl_tpu_torch.readImagesPacked(jpeg_dir, YUV_SRC,
                                            numPartitions=3,
                                            packedFormat="yuv420")
    out = transformer.transform(df).collect()
    assert list(out["filePath"]) == table.column("filePath").to_pylist()
    assert len(out["filePath"]) == 9
    np.testing.assert_array_equal(out["image"], packed)
    assert out["features"].shape == ref.shape == (9, 16)
    assert out["features"].dtype == np.float32
    assert transformer.metrics.rows == 9
    assert transformer.metrics.batches == 3  # partitions of 3 rows

    # rows where the two 4:2:0 ops round a tie pixel to different counts
    got_u8 = fused_yuv420_resize_normalize(
        torch.from_numpy(np.array(packed)), YUV_SRC, (32, 32),
        out_dtype=torch.uint8).numpy()
    ref_u8 = np.clip(np.round(np.asarray(jax_yuv(packed, YUV_SRC,
                                                 (32, 32)))), 0, 255)
    tie_rows = (got_u8 != ref_u8).any(axis=(1, 2, 3))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out["features"][~tie_rows], ref[~tie_rows],
                               rtol=0, atol=TOL_FEATURES * scale)
    np.testing.assert_allclose(out["features"], ref, rtol=0,
                               atol=TOL_FEATURES_TIE * scale)


class _TwoInOne(torch.nn.Module):
    def forward(self, inputs):
        return {"y": inputs["a"].float().sum(1) * inputs["k"].float()[:, 0]}


def _jax_and_torch_two_input_models():
    import jax.numpy as jnp
    from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
    from sparkdl_tpu_torch.graph.function import ModelFunction
    sig = {"a": ((3,), np.float32), "k": ((1,), np.float32)}
    jax_mf = JaxModelFunction(
        lambda p, x: {"y": jnp.sum(x["a"], 1) * x["k"][:, 0]}, {},
        input_signature=sig, output_names=["y"], name="two")
    return jax_mf, ModelFunction(_TwoInOne(), sig, ["y"], device="cpu",
                                 name="two")


@pytest.mark.parametrize("params", [
    {"inputMapping": {"a": "a", "k": "nope"}, "outputMapping": {"y": "y"}},
    {"inputMapping": {"a": "a"}, "outputMapping": {"nope": "y"},
     "tfHParams": {"k": [2.0]}},
    {"inputMapping": {"a": "a"}, "outputMapping": {"y": "y"}},
    {"inputMapping": {"a": "a"}, "outputMapping": {"y": "y"},
     "tfHParams": {"k": [2.0, 3.0]}},
    {"inputMapping": {"a": "a"}, "outputMapping": {"y": "y"},
     "tfHParams": {"nope": 1.0}},
    {"inputMapping": {"a": "a", "k": "k"}, "outputMapping": {"y": "y"},
     "tfHParams": {"k": [2.0]}},
], ids=["unknown_input", "unknown_output", "unmapped_input",
        "hparam_shape", "unknown_hparam", "input_and_hparam"])
def test_tensor_transformer_validates_like_jax(params):
    from sparkdl_tpu.transformers.tensor_transform import (
        TensorTransformer as JaxTensorTransformer,
    )
    from sparkdl_tpu_torch import TensorTransformer
    jax_mf, mf = _jax_and_torch_two_input_models()
    with pytest.raises(ValueError) as jax_err:
        JaxTensorTransformer(modelFunction=jax_mf, **params)._validate()
    with pytest.raises(ValueError) as err:
        TensorTransformer(modelFunction=mf, **params)._validate()
    assert str(err.value) == str(jax_err.value)


def test_tensor_transformer_broadcasts_hparams_and_names_bad_columns():
    from sparkdl_tpu_torch import DataFrame, TensorTransformer
    from sparkdl_tpu_torch.transformers.utils import reshapeRows
    _, mf = _jax_and_torch_two_input_models()
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    df = DataFrame.from_columns({"a": a}, num_partitions=2)
    out = TensorTransformer(modelFunction=mf, inputMapping={"a": "a"},
                            outputMapping={"y": "out"}, batchSize=2,
                            tfHParams={"k": [2.0]}).transform(df).collect()
    np.testing.assert_array_equal(out["out"], a.sum(1) * 2)
    bad = DataFrame.from_columns({"a": np.zeros((4, 5), np.float32)})
    with pytest.raises(ValueError, match="column 'a' rows carry 5 elements"):
        TensorTransformer(modelFunction=mf, inputMapping={"a": "a"},
                          outputMapping={"y": "out"},
                          tfHParams={"k": [2.0]}).transform(bad).collect()
    # dynamic dims skip the reshape; zero rows reshape legally
    assert reshapeRows(np.zeros((0,)), (2, 3), np.float32,
                       None).shape == (0, 2, 3)
    assert reshapeRows(np.zeros((2, 6)), (None,), np.uint8,
                       None).dtype == np.uint8


def test_device_resize_model_refuses_what_jax_refuses():
    from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
    from sparkdl_tpu.transformers.utils import (
        deviceResizeModel as jax_device_resize,
    )
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.models import zoo
    from sparkdl_tpu_torch.transformers.utils import deviceResizeModel
    mf = zoo.getModelFunction("TestNet", device="cpu")
    gray = ModelFunction(_MeanPixel(), {"img": ((8, 8, 1), np.uint8)},
                         ["m"], device="cpu")
    jax_gray = JaxModelFunction(lambda p, x: {"m": x["img"]}, {},
                                input_signature={"img": ((8, 8, 1),
                                                         np.uint8)},
                                output_names=["m"])
    for model, jax_model, kw in (
            (mf, None, {"packedFormat": "yuv420", "use_pallas": True}),
            (gray, jax_gray, {"packedFormat": "yuv420"}),
            (mf, None, {"packedFormat": "yuv420", "src_hw": (23, 24)}),
            (mf, None, {"packedFormat": "bgr"})):
        kw = {"src_hw": (24, 24), **kw}
        if jax_model is None:
            from sparkdl_tpu.models import zoo as jax_zoo
            jax_model = jax_zoo.getModelFunction("TestNet")
        with pytest.raises(ValueError) as jax_err:
            jax_device_resize(jax_model, **kw)
        with pytest.raises(ValueError) as err:
            deviceResizeModel(model, **kw)
        assert str(err.value) == str(jax_err.value)


# ---------------------------------------------------------------------------
# DeepImagePredictor, outputMode="image", deviceResizeFrom at the model's
# size — each against the JAX package on the same rows
# ---------------------------------------------------------------------------

@pytest.fixture
def empty_caches(tmp_path, monkeypatch):
    """Both packages' weight caches empty: each serves its committed
    TestNet (the port reads it with its own msgpack reader)."""
    monkeypatch.setenv("SPARKDL_TPU_MODEL_CACHE", str(tmp_path / "jax"))
    monkeypatch.setenv("SPARKDL_TPU_TORCH_MODEL_CACHE",
                       str(tmp_path / "torch"))


def _frames(structs, num_partitions=2):
    """The same image structs as a frame of each package: (JAX, port)."""
    import pyarrow as pa
    from sparkdl_tpu.data.frame import DataFrame as JaxDataFrame
    from sparkdl_tpu.image import imageIO as jax_io
    from sparkdl_tpu_torch import DataFrame
    table = pa.Table.from_batches([jax_io.structsToBatch(structs)])
    return (JaxDataFrame.from_table(table, num_partitions),
            DataFrame.from_pylist([{"image": s} for s in structs],
                                  num_partitions))


def _jax_tensor(table, name):
    from sparkdl_tpu.data.tensors import arrow_to_tensor
    idx = table.schema.get_field_index(name)
    return arrow_to_tensor(table.column(idx), table.schema.field(idx))


def test_device_resize_at_model_size_resizes_off_size_rows_on_host(
        empty_caches):
    """``deviceResizeFrom`` equal to the model's input size leaves nothing
    to resize on the device: the host path runs and resizes an off-size
    row, as in the JAX package (the port raised ValueError on the 40×40
    row before)."""
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    rng = np.random.default_rng(21)
    structs = [imageArrayToStruct(rng.integers(0, 256, shape,
                                               dtype=np.uint8), origin=o)
               for shape, o in (((40, 40, 3), "a"), ((32, 32, 3), "b"))]
    jax_df, df = _frames(structs, 1)
    kw = dict(inputCol="image", outputCol="f", modelName="TestNet",
              deviceResizeFrom=(32, 32))
    ref = _jax_tensor(sparkdl_tpu.DeepImageFeaturizer(**kw).transform(
        jax_df).collect(), "f")
    got = sparkdl_tpu_torch.DeepImageFeaturizer(device="cpu", **kw) \
        .transform(df).collect()["f"]
    assert got.shape == ref.shape == (2, 16)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=TOL_FEATURES * np.abs(ref).max())


def _testnet_structs(n, seed):
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.models.testnet import synthetic_testnet_dataset
    x, y = synthetic_testnet_dataset(n, seed=seed)
    return [imageArrayToStruct(a, origin=f"r{i}")
            for i, a in enumerate(x)], y


@pytest.mark.parametrize("decode,top,index_file", [
    (False, 5, False), (True, 1, False), (True, 3, False), (True, 3, True)],
    ids=["raw", "top1", "top3", "top3_classIndexFile"])
def test_predictor_matches_jax_on_committed_testnet(empty_caches, tmp_path,
                                                    decode, top,
                                                    index_file):
    """``DeepImagePredictor`` on the committed TestNet (read by the port's
    msgpack reader) against the JAX one on the same rows: raw softmax
    scores within ``TOL_FEATURES`` of the largest, or decoded rows with
    the same class ids in the same order, scores as ``np.float32``
    within the same tolerance; with ``classIndexFile`` the names come
    from that file. The decoded column replaces the raw one in both."""
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu.models import zoo as jax_zoo
    from sparkdl_tpu_torch.models import zoo
    assert zoo.weights_provenance("TestNet") == "committed"
    assert jax_zoo.weights_provenance("TestNet") == "committed"
    structs, labels = _testnet_structs(12, seed=5)
    jax_df, df = _frames(structs, 3)
    kw = dict(inputCol="image", outputCol="p", modelName="TestNet",
              decodePredictions=decode, topK=top, batchSize=4)
    if index_file:
        path = tmp_path / "index.json"
        path.write_text(json.dumps({str(i): [f"id{i}", f"name {i}"]
                                    for i in range(10)}))
        kw["classIndexFile"] = str(path)
    table = sparkdl_tpu.DeepImagePredictor(**kw).transform(jax_df).collect()
    out = sparkdl_tpu_torch.DeepImagePredictor(device="cpu", **kw) \
        .transform(df).collect()
    assert list(out) == table.column_names == ["image", "p"]
    if not decode:
        ref = _jax_tensor(table, "p")
        assert out["p"].shape == ref.shape == (12, 10)
        np.testing.assert_allclose(out["p"], ref, rtol=0,
                                   atol=TOL_FEATURES * np.abs(ref).max())
        assert (out["p"].argmax(1) == labels).mean() >= 0.95
        return
    ref_rows = table.column("p").to_pylist()
    assert len(out["p"]) == len(ref_rows) == 12
    for got, ref in zip(out["p"], ref_rows):
        assert [e["class"] for e in got] == [e["class"] for e in ref]
        assert [e["description"] for e in got] == \
            [e["description"] for e in ref]
        assert all(type(e["score"]) is np.float32 for e in got)
        np.testing.assert_allclose([e["score"] for e in got],
                                   [e["score"] for e in ref], rtol=0,
                                   atol=TOL_FEATURES)
    for row in out["p"]:
        for e in row:
            i = int(e["class"].lstrip("id").split("_")[-1])
            assert e["description"] == (f"name {i}" if index_file
                                        else f"prototype_{i}")
    top1 = [int(row[0]["class"].lstrip("id").split("_")[-1])
            for row in out["p"]]
    assert (np.array(top1) == labels).mean() >= 0.95


def test_predictor_with_device_resize_matches_jax(png_dir, empty_caches):
    """``DeepImagePredictor(deviceResizeFrom=...)`` in both packages on
    the same files: the raw scores as the featurizer's features are
    compared (rows where the two resizes round a tie pixel apart within
    ``TOL_FEATURES_TIE``), and the decoded top-3 rows hold the class ids
    of the port's own raw scores, ranked by ``decode_predictions``."""
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu_torch.models import zoo
    kw = dict(inputCol="image", outputCol="p", modelName="TestNet",
              deviceResizeFrom=(40, 56), batchSize=4)
    table = sparkdl_tpu.DeepImagePredictor(**kw).transform(
        sparkdl_tpu.readImages(png_dir, numPartitions=3)).collect()
    ref = _jax_tensor(table, "p")
    df = sparkdl_tpu_torch.readImages(png_dir, numPartitions=3)
    raw = sparkdl_tpu_torch.DeepImagePredictor(device="cpu", **kw) \
        .transform(df).collect()["p"]
    from PIL import Image
    paths = table.column("filePath").to_pylist()
    x = np.stack([np.asarray(Image.open(p)) for p in paths])
    got_u8, ref_u8, _ = resize_round_both(x, (32, 32))
    tie_rows = (got_u8 != ref_u8).any(axis=(1, 2, 3))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(raw[~tie_rows], ref[~tie_rows], rtol=0,
                               atol=TOL_FEATURES * scale)
    np.testing.assert_allclose(raw, ref, rtol=0,
                               atol=TOL_FEATURES_TIE * scale)
    decoded = sparkdl_tpu_torch.DeepImagePredictor(
        device="cpu", decodePredictions=True, topK=3, **kw).transform(
        df).collect()["p"]
    want = zoo.decode_predictions(raw, top=3,
                                  class_index=zoo.model_class_index(
                                      "TestNet"))
    assert [[e["class"] for e in row] for row in decoded] == \
        [[c for c, _, _ in row] for row in want]


class _Affine(torch.nn.Module):
    def forward(self, inputs):
        return {"y": inputs["img"].to(torch.float32) * 1.5 - 20.25}


def test_image_output_mode_matches_jax():
    """``outputMode="image"``: a float model output is rounded (half to
    even), clipped and cast to uint8 image structs, as the JAX package's
    ``outputToImageStructs`` does; here through ``ImageTransformer`` in
    both packages (x * 1.5 - 20.25 is exact in float32, so the structs
    are byte-equal), and the helper alone on values at .5, below 0 and
    above 255, and on uint8 input."""
    import jax.numpy as jnp
    from sparkdl_tpu.graph.function import ModelFunction as JaxModelFunction
    from sparkdl_tpu.transformers.image_transform import (
        ImageTransformer as JaxImageTransformer,
    )
    from sparkdl_tpu.transformers.utils import (
        outputToImageStructs as jax_to_structs,
    )
    from sparkdl_tpu_torch import ImageTransformer
    from sparkdl_tpu_torch.graph.function import ModelFunction
    from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
    from sparkdl_tpu_torch.transformers.utils import outputToImageStructs
    rng = np.random.default_rng(22)
    structs = [imageArrayToStruct(rng.integers(0, 256, (6, 5, 3),
                                               dtype=np.uint8))
               for _ in range(5)]
    jax_df, df = _frames(structs)
    sig = {"img": ((6, 5, 3), np.uint8)}
    jax_mf = JaxModelFunction(
        lambda p, x: {"y": x["img"].astype(jnp.float32) * 1.5 - 20.25}, {},
        input_signature=sig, output_names=["y"])
    mf = ModelFunction(_Affine(), sig, ["y"], device="cpu")
    kw = dict(inputCol="image", outputCol="out", outputMode="image",
              batchSize=2)
    ref = JaxImageTransformer(modelFunction=jax_mf, **kw).transform(
        jax_df).collect().column("out").to_pylist()
    got = ImageTransformer(modelFunction=mf, **kw).transform(df).collect()
    assert list(got["out"]) == ref
    assert ref[0]["height"] == 6 and ref[0]["nChannels"] == 3

    arr = np.array([-3.0, -0.5, 0.5, 1.5, 2.5, 254.5, 255.49, 300.0],
                   np.float32).reshape(2, 2, 2, 1)
    for a, origins in ((arr, None), (arr.astype(np.float64), ["x", "y"]),
                       (rng.integers(0, 256, (2, 3, 4, 3),
                                     dtype=np.uint8), None)):
        assert list(outputToImageStructs(a, origins)) == \
            jax_to_structs(a, origins).to_pylist()
    with pytest.raises(ValueError, match="needs \\[N,H,W,C\\]"):
        outputToImageStructs(arr[:, 0])
    with pytest.raises(TypeError, match="outputMode"):
        ImageTransformer(modelFunction=mf, outputMode="vectors")


# ---------------------------------------------------------------------------
# the runtime under the paths: uneven partitions through the engine's
# re-chunking, and the model build without torch's default init
# ---------------------------------------------------------------------------

UNEVEN = (5, 0, 17, 3, 9, 1, 12, 7, 0, 20, 2, 6)


def test_featurizer_over_uneven_partitions_matches_jax(empty_caches):
    """``DeepImageFeaturizer("TestNet")`` over 12 uneven partitions (two
    of them empty) in both packages: the same features within
    TOL_FEATURES, rows in order, and the port's runner reports the JAX
    runner's batch count (the engines cut the same 16-row blocks across
    partitions)."""
    import pyarrow as pa
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu.data.frame import DataFrame as JaxDataFrame
    from sparkdl_tpu.image import imageIO as jax_io
    from sparkdl_tpu_torch.data.frame import DataFrame, Source, to_column
    structs, _ = _testnet_structs(sum(UNEVEN), seed=5)
    bounds = np.cumsum((0,) + UNEVEN)
    parts = [structs[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]
    jax_df = JaxDataFrame.from_batches(
        [jax_io.structsToBatch(p) if p else pa.RecordBatch.from_pylist(
            [], schema=jax_io.structsToBatch(structs[:1]).schema)
         for p in parts])
    df = DataFrame([Source(lambda p=p: {"image": to_column(p)}, len(p))
                    for p in parts])
    kw = dict(inputCol="image", outputCol="f", modelName="TestNet",
              batchSize=16)
    jax_featurizer = sparkdl_tpu.DeepImageFeaturizer(**kw)
    ref = _jax_tensor(jax_featurizer.transform(jax_df).collect(), "f")
    featurizer = sparkdl_tpu_torch.DeepImageFeaturizer(device="cpu", **kw)
    out = featurizer.transform(df).collect()
    assert [s["origin"] for s in out["image"]] == \
        [s["origin"] for s in structs]
    assert out["f"].shape == ref.shape == (sum(UNEVEN), 16)
    np.testing.assert_allclose(out["f"], ref, rtol=0,
                               atol=TOL_FEATURES * np.abs(ref).max())
    assert featurizer.metrics.batches == jax_featurizer.metrics.batches \
        == -(-sum(UNEVEN) // 16)
    assert featurizer.metrics.rows == sum(UNEVEN)


@pytest.mark.parametrize("name", ["TestNet", "InceptionV3", "ResNet50"])
def test_meta_build_leaves_no_meta_tensor(empty_caches, name):
    """The zoo builds each network on the meta device and assigns its
    weights: every parameter and buffer (BatchNorm's running statistics
    included) ends up real, on the CPU, holding the weights the state
    dict gave, and no two model functions share a tensor."""
    from sparkdl_tpu_torch.models import zoo
    mf = zoo.getModelFunction(name, device="cpu")
    other = zoo.getModelFunction(name, device="cpu")
    state = zoo.load_state_dict(name)
    tensors = dict(mf.module.net.named_parameters())
    tensors.update(mf.module.net.named_buffers())
    assert set(tensors) == set(state)
    for key, t in tensors.items():
        assert not t.is_meta and t.device.type == "cpu", key
        torch.testing.assert_close(t, state[key], rtol=0, atol=0)
    ptrs = {t.data_ptr() for t in other.module.parameters()}
    assert not ptrs & {t.data_ptr() for t in mf.module.parameters()}


def test_meta_build_refuses_a_tensor_left_on_meta():
    """A buffer outside the state dict (non-persistent) would stay on the
    meta device: the build raises instead of shipping it."""
    from sparkdl_tpu_torch.models.zoo import build_module

    class WithScratch(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(2, 2)
            self.register_buffer("scratch", torch.ones(2), persistent=False)

    state = {"lin.weight": torch.ones(2, 2), "lin.bias": torch.zeros(2)}
    with pytest.raises(RuntimeError, match="scratch"):
        build_module(WithScratch, state, torch.device("cpu"))
    net = build_module(torch.nn.Linear, state_dict_of_linear(),
                       torch.device("cpu"), in_features=2, out_features=3)
    assert net.weight.dtype == torch.float32 and not net.weight.is_meta


def state_dict_of_linear():
    return {"weight": torch.arange(6, dtype=torch.float64).view(3, 2),
            "bias": torch.zeros(3, dtype=torch.float64)}


def test_transfer_pipeline_matches_jax_on_committed_testnet(empty_caches,
                                                            monkeypatch):
    """The transfer-learning flow, ``Pipeline([DeepImageFeaturizer(
    "TestNet"), LogisticRegression()])``, fitted in both packages on the
    same 384 train images from the same initial weights (the JAX
    package's draw, carried across), then scored on 128 held-out images:
    the same held-out accuracy, and probabilities within TOL_PROB (the
    features agree within TOL_FEATURES and the two Adam runs differ only
    in summation order)."""
    import pyarrow as pa
    import sparkdl_tpu
    import sparkdl_tpu_torch
    from sparkdl_tpu.data.frame import DataFrame as JaxDataFrame
    from sparkdl_tpu.estimators.logistic_regression import (
        LogisticRegression as JaxLR,
    )
    from sparkdl_tpu.image import imageIO as jax_io
    from sparkdl_tpu_torch.estimators.logistic_regression import (
        LogisticRegression,
    )
    TOL_PROB = 1e-5

    def jax_init(self, n_features, n_classes):
        params, _, _ = JaxLR(seed=self.getOrDefault("seed"))._init_params(
            n_features, n_classes)
        return np.asarray(params["W"]), np.asarray(params["b"])

    monkeypatch.setattr(LogisticRegression, "_init_params", jax_init)

    def frames(n, seed):
        structs, labels = _testnet_structs(n, seed=seed)
        batch = jax_io.structsToBatch(structs).append_column(
            "label", pa.array(labels.astype(np.int64)))
        jax_df = JaxDataFrame.from_table(pa.Table.from_batches([batch]), 4)
        df = sparkdl_tpu_torch.DataFrame.from_pylist(
            [{"image": s, "label": int(l)} for s, l in zip(structs, labels)],
            4)
        return jax_df, df

    (jax_train, train), (jax_test, test) = frames(384, 0), frames(128, 1)
    kw = dict(inputCol="image", outputCol="features", modelName="TestNet",
              batchSize=32)
    jax_model = sparkdl_tpu.Pipeline(stages=[
        sparkdl_tpu.DeepImageFeaturizer(**kw),
        sparkdl_tpu.LogisticRegression(maxIter=50)]).fit(jax_train)
    model = sparkdl_tpu_torch.Pipeline(stages=[
        sparkdl_tpu_torch.DeepImageFeaturizer(device="cpu", **kw),
        sparkdl_tpu_torch.LogisticRegression(maxIter=50, device="cpu"),
    ]).fit(train)
    ref = jax_model.transform(jax_test)
    out = model.transform(test)
    np.testing.assert_allclose(out.collect()["probability"],
                               _jax_tensor(ref.collect(), "probability"),
                               rtol=0, atol=TOL_PROB)
    acc = sparkdl_tpu_torch.ClassificationEvaluator().evaluate(out)
    assert acc == sparkdl_tpu.ClassificationEvaluator().evaluate(ref)
    assert acc >= 0.95
