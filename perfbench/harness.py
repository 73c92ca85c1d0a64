"""The benchmark's plumbing: the manifest, finding a cell's files by
name, the card's description, the per-layer record, and the result line.

Everything that belongs to one configuration, traffic mix, kernel or
per-layer metric lives in a file of its own that is found by the name
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``   the model, its sizes and its reference;
* ``traffic/<mix>.json``      the mix's parameters; its ``kind`` names
                              the driver ``traffic/<kind>.py``;
* ``limits/<workload>.json``  the limit of each number the cell compares;
* ``metrics/<metric>.py``     a reader ``read(record)`` of one per-layer
                              metric (``None`` where it finds nothing);
* ``kernels/<kernel>.py``     a kernel's work per call and its trace name;
* ``reference/<module>.py``   the plain reference a configuration names:
                              ``forward(state, x, quant)``,
                              ``param_shapes()`` and, where a key's
                              suffix does not say how it is seeded,
                              ``param_kinds()``.

A configuration's ``weights`` is its seeding scheme, read by
``weights.py`` by each parameter's kind (``kernel``, ``gamma``, ``var``,
``mean``, ``beta``, ``bias``, ``embedding``): ``bn_gamma``, ``bn_var``,
``bn_mean_std``, ``bn_beta_std``, ``bias_std``, ``embedding_std``, and
the patterns ``bn_scale`` that scale the scales whose keys they name.
So a new model is new files only.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# top-level module names that must not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sparkdl_tpu")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: Optional[str] = None):
    """A Python file of the benchmark, loaded by path (its name may hold
    dots, as a metric's does)."""
    name = name or "perfbench_file_" + "".join(
        c if c.isalnum() else "_" for c in os.path.relpath(path, HERE))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with its files read."""
    name: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[dict]
    per_layer: List[dict]
    bench_dir: str

    @property
    def kind(self) -> str:
        return self.mix["kind"]

    def driver(self):
        return load_module(os.path.join(self.bench_dir, "traffic",
                                        f"{self.kind}.py"))

    def reference(self):
        return load_module(os.path.join(self.bench_dir, "reference",
                                        f"{self.config['reference']}.py"))


def _reports(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def resolve(workload: str, manifest_path: Optional[str] = None) -> Cell:
    """The cell ``workload`` of the manifest (``BENCHMARK.json`` at the
    checkout's root by default), with its configuration, mix and limits
    read from their files, and the metrics it reports. Paths in the
    manifest are relative to its directory."""
    manifest_path = manifest_path or os.path.join(ROOT, "BENCHMARK.json")
    root = os.path.dirname(os.path.abspath(manifest_path))
    manifest = read_json(manifest_path)
    bench_dir = os.path.join(root, manifest["paths"][0])
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest "
                         f"has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = read_json(os.path.join(root, configs[w["config"]]["file"]))
    mix = read_json(os.path.join(bench_dir, "traffic",
                                 f"{w['traffic']}.json"))
    limits = read_json(os.path.join(bench_dir, "limits",
                                    f"{workload}.json"))
    return Cell(
        name=workload, chips=int(w["chips"]), config=config, mix=mix,
        limits=limits,
        end_to_end=[m for m in manifest["end_to_end"]
                    if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"]
                   if _reports(m, workload)],
        bench_dir=bench_dir)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of
    ``FORBIDDEN_MODULES``, compared whole (``sparkdl_tpu_torch`` is not
    ``sparkdl_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else None


class GcPauses:
    """The interpreter's cyclic collections while installed: per
    generation how many and the longest, in seconds (a collection stops
    every thread of the process)."""

    def __init__(self):
        self.count = [0, 0, 0]
        self.longest = [0.0, 0.0, 0.0]
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            g = info["generation"]
            self.count[g] += 1
            self.longest[g] = max(self.longest[g],
                                  time.perf_counter() - self._t)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        return False

    def line(self) -> str:
        return ("gc collections by generation " + repr(self.count)
                + ", longest ms " + repr([round(t * 1e3, 3)
                                          for t in self.longest]))


@dataclasses.dataclass
class Record:
    """What a traced sub-window left for the per-layer readers. Times
    are seconds; counters are deltas over the sub-window."""
    window_s: float
    images: int = 0
    batches: int = 0
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    runner: Dict[str, float] = dataclasses.field(default_factory=dict)
    device_ops: List[tuple] = dataclasses.field(default_factory=list)
    busy_s: float = 0.0
    geometry: Dict[str, Any] = dataclasses.field(default_factory=dict)
    flops_per_image: float = 0.0
    bench_dir: str = HERE
    # the window's passes outside the profiled sub-window: images, seconds
    plain_images: int = 0
    plain_s: float = 0.0

    def kernel(self, name: str):
        """The work-count module ``kernels/<name>.py``."""
        return load_module(os.path.join(self.bench_dir, "kernels",
                                        f"{name}.py"))

    def op_time(self, pattern: str):
        """(calls, device seconds) of the device ops whose name holds
        ``pattern``."""
        calls = [e - s for n, s, e in self.device_ops if pattern in n]
        return len(calls), sum(calls)


def read_per_layer(cell: Cell, record: Record) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a reader that
    finds nothing leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(os.path.join(cell.bench_dir, "metrics",
                                          f"{m['name']}.py"))
        value = reader.read(record)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: Dict[str, Any],
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    """The run's last line of standard output; the compared numbers
    come last."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
