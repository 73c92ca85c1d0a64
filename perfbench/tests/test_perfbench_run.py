"""Whole runs on the CPU: tiny cells added as new files only, driven
through set-up, the window, the comparison and the result line at the
configurations' own widths and input sizes; the faults the comparison
must catch; the control; the import check."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import harness, run
from conftest import ROOT, TINY_CELLS

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def drive(tiny, capsys, workload, trace=0, seed=3_000_000_019):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.3", "--trace", str(trace)],
                  device="cpu", manifest=tiny)
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    return line, err


@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
def test_a_tiny_cell_runs_whole_and_is_correct(tiny, capsys, workload):
    line, err = drive(tiny, capsys, workload)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = harness.resolve(workload, tiny)
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    check = line["checks"]["out_rel_err_max"]
    assert 0 < check["value"] < check["limit"]
    assert err.strip().splitlines()[-1].startswith("check out_rel_err_max")


@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
def test_a_traced_run_reads_its_per_layer_metrics(tiny, capsys, workload):
    line, _ = drive(tiny, capsys, workload, trace=1)
    assert line["correct"] is True
    cell = harness.resolve(workload, tiny)
    allowed = {m["name"] for m in cell.per_layer}
    assert set(line["metrics"]) <= allowed
    assert line["device"]["window_s"] > 0
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(line["breakdown"]["idle_gaps"]) <= 10


def _alter_answers(monkeypatch):
    """A wrong answer where it is produced: the model's first row of
    every batch moved."""
    from sparkdl_tpu_torch.models import zoo
    forward = zoo.ZooModel.forward

    def altered(self, inputs):
        out = forward(self, inputs)
        return {k: v.clone().index_add_(0, v.new_zeros(1, dtype=int),
                                        v[:1] * 0.5)
                for k, v in out.items()}
    monkeypatch.setattr(zoo.ZooModel, "forward", altered)


def _swap_rows(monkeypatch):
    """The answers of a batch handed back out of order."""
    from sparkdl_tpu_torch.models import zoo
    forward = zoo.ZooModel.forward

    def swapped(self, inputs):
        return {k: v.flip(0) for k, v in forward(self, inputs).items()}
    monkeypatch.setattr(zoo.ZooModel, "forward", swapped)


def _drop_batchnorm(term):
    """A BatchNorm fold that leaves out its running mean or its offset."""
    def plant(monkeypatch):
        from sparkdl_tpu_torch.models import layers

        def forward(self, x, train=False):
            shape = (1, -1, 1, 1)
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = x.to(torch.float32)
            if term != "mean":
                y = y - self.running_mean.view(shape)
            y = y * mul.view(shape)
            return y + self.bias.view(shape) if term != "offset" else y
        monkeypatch.setattr(layers.BatchNorm, "forward", forward)
    plant.__name__ = f"_drop_batchnorm_{term}"
    return plant


def _drop_conv_bias(monkeypatch):
    """Convs that leave out their bias (ResNet50's carry one)."""
    from sparkdl_tpu_torch.models import layers
    conv2d = layers.conv2d

    def unbiased(x, conv, padding, dtype):
        y = conv2d(x, conv, padding, dtype)
        if conv.bias is not None:
            y = y - conv.bias.to(dtype).view(1, -1, 1, 1)
        return y
    monkeypatch.setattr(layers, "conv2d", unbiased)


FAULTS = {"inceptionv3.tiny_yuv": [_alter_answers, _swap_rows,
                                   _drop_batchnorm("mean"),
                                   _drop_batchnorm("offset")],
          "resnet50.tiny_rgb": [_alter_answers, _swap_rows,
                                _drop_batchnorm("mean"),
                                _drop_batchnorm("offset"),
                                _drop_conv_bias]}


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w, faults in sorted(FAULTS.items()) for f in faults],
    ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(tiny, capsys, monkeypatch,
                                            workload, fault):
    fault(monkeypatch)
    line, _ = drive(tiny, capsys, workload)
    assert line["correct"] is False
    check = line["checks"]["out_rel_err_max"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("control", ["fp8_operands", "fp8_values"])
@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
def test_a_control_in_the_programs_place_is_not_correct(
        tiny, capsys, monkeypatch, workload, control):
    """The reference one precision down, put in place of the program's
    network on the timed path: the run reports ``correct`` false."""
    from perfbench.reference.layers import CONTROLS
    from sparkdl_tpu_torch.models import zoo
    ref = harness.resolve(workload, tiny).reference()

    def lower(self, inputs):
        state = {k: v.float() for k, v in self.net.state_dict().items()}
        key = "features" if self.featurize else "predictions"
        return {key: ref.forward(state, inputs["image"],
                                 quant=CONTROLS[control])}
    monkeypatch.setattr(zoo.ZooModel, "forward", lower)
    line, _ = drive(tiny, capsys, workload)
    assert line["correct"] is False
    check = line["checks"]["out_rel_err_max"]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("workload", sorted(TINY_CELLS))
def test_the_controls_fail_the_limit(tiny, workload):
    """Each control's own reading lies above the limit, on every seed
    tried."""
    from perfbench import control
    out = control.main(["--workload", workload, "--seeds", "1", "2"],
                       device="cpu", manifest=tiny)
    assert all(o[c] > o["limit"] for o in out
               for c in ("fp8_operands", "fp8_values"))


def test_a_new_per_layer_metric_is_a_new_file(tiny, capsys):
    """A reader and a manifest entry, nothing edited: the traced line
    carries it."""
    bench = os.path.dirname(tiny)
    with open(os.path.join(bench, "perfbench", "metrics",
                           "test.images.py"), "w") as f:
        f.write("def read(rec):\n    return float(rec.images) or None\n")
    with open(tiny) as f:
        manifest = json.load(f)
    manifest["per_layer"].append({
        "name": "test.images", "unit": "images", "better": "higher",
        "source": "program_counter", "layer": "runner",
        "moves": "images_per_s", "workloads": ["resnet50.tiny_rgb"]})
    extended = os.path.join(bench, "extended.json")
    with open(extended, "w") as f:
        json.dump(manifest, f)
    line, _ = drive(extended, capsys, "resnet50.tiny_rgb", trace=1)
    assert line["metrics"]["test.images"]["value"] >= 4


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("sparkdl_tpu_torch", "sparkdl_tpu_torch.models",
                 "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    for name in ("sparkdl_tpu", "sparkdl_tpu.models", "jax.numpy",
                 "jaxlib", "flax"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == sorted(
        ["sparkdl_tpu", "sparkdl_tpu.models", "jax.numpy", "jaxlib",
         "flax"])


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.inceptionv3, "
            "perfbench.reference.resnet50, perfbench.check, "
            "perfbench.weights, perfbench.inputs\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('sparkdl_tpu_torch', 'sparkdl_tpu', 'jax', 'jaxlib', "
            "'flax'))\nprint(bad)" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr[-2000:]


def test_a_run_without_a_card_prints_no_result(tiny):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", "inceptionv3.packed_yuv420_150", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.chip
def test_a_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
         "--workload", "resnet50.packed_rgb256", "--seed", "12345",
         "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """A checkout holding only the manifest and the benchmark's files
    (no program) exits non-zero without a result line."""
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    str(tmp_path / "perfbench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import run\n"
            "sys.exit(run.main(['--workload', "
            "'inceptionv3.packed_yuv420_150', '--seed', '1', '--seconds', "
            "'1', '--trace', '0'], device='cpu'))" % str(tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "sparkdl_tpu_torch" in out.stderr
