"""Shared fixtures of the benchmark's tests: a copy of the benchmark in a
temporary directory with tiny cells added as new files only (mixes,
limits, manifest entries), which the CPU drives through the whole of a
run at the configurations' own widths and input sizes, a few rows at a
time.

Tests that need the card carry the ``chip`` marker and decide inside a
fixture whether one is there."""

import copy
import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_MIXES = {
    "tiny_yuv": {"kind": "packed", "format": "yuv420", "src_hw": [150, 150],
                 "rows": 4, "partitions": 2, "batch": 2,
                 "trace_min_s": 0.05},
    "tiny_rgb": {"kind": "packed", "format": "rgb", "src_hw": [256, 256],
                 "rows": 4, "partitions": 2, "batch": 2,
                 "trace_min_s": 0.05},
}
# tiny cell -> (configuration, mix, the real cell whose metrics and
# limits it takes)
TINY_CELLS = {
    "inceptionv3.tiny_yuv": ("inceptionv3", "tiny_yuv",
                             "inceptionv3.packed_yuv420_150"),
    "resnet50.tiny_rgb": ("resnet50", "tiny_rgb", "resnet50.packed_rgb256"),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")


def add_tiny_cells(root: str) -> str:
    """Copy the benchmark under ``root`` and add the tiny cells as new
    files and manifest entries; returns the copy's manifest path."""
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for name, mix in TINY_MIXES.items():
        with open(os.path.join(root, "perfbench", "traffic",
                               f"{name}.json"), "w") as f:
            json.dump(mix, f)
    for cell, (config, mix, like) in TINY_CELLS.items():
        manifest["workloads"].append({"name": cell, "config": config,
                                      "traffic": mix, "chips": 1,
                                      "why": "a tiny cell for the CPU"})
        with open(os.path.join(root, "perfbench", "limits",
                               f"{like}.json")) as f:
            limits = json.load(f)
        with open(os.path.join(root, "perfbench", "limits",
                               f"{cell}.json"), "w") as f:
            json.dump(limits, f)
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """The copy's manifest path."""
    return add_tiny_cells(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="session")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return copy.deepcopy(json.load(f))
