"""The manifest against the benchmark's contract, and every cell
resolved to its files."""

import json
import os
import re

import pytest

from perfbench import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}\Z")
LINE = re.compile(r"[^\t\n\r]{1,200}\Z")
ROOT = harness.ROOT

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == TOP_KEYS
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(LINE.match(w) for w in cmd)
    files = [w for w in cmd if os.sep in w]
    assert all(any(f.startswith(p + "/") for p in manifest["paths"])
               for f in files)
    assert 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_a_full_check_fits_its_budget(manifest):
    """2 + 14 runs a cell at run_seconds + 60 each, 2 x 90 s of compile a
    cell and 1,200 s spare, with the full 24 cells."""
    runs = 2 + 14 * 24
    total = runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200
    assert total <= 43200


def test_names_units_and_lines(manifest):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in manifest[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and section != "end_to_end" \
                        and not (section == "per_layer" and key == "source"):
                    assert LINE.match(entry[key]), (key, entry[key])
    assert len(names) == len(set(names))
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_entries_have_exactly_the_contracts_keys(manifest):
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_resolves_to_its_files(manifest):
    used = set()
    for w in manifest["workloads"]:
        cell = harness.resolve(w["name"])
        used.add(w["config"])
        assert cell.config["name"] == w["config"]
        assert os.path.exists(os.path.join(cell.bench_dir, "traffic",
                                           f"{cell.kind}.py"))
        assert hasattr(cell.driver(), "setup")
        assert hasattr(cell.reference(), "forward")
        assert "out_rel_err_max" in cell.limits["numbers"]
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
    assert used == {c["name"] for c in manifest["configs"]}


def test_configuration_files(manifest):
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files))
    for c in manifest["configs"]:
        assert c["file"].startswith(manifest["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]


def test_per_layer_metrics_move_a_metric_their_cells_report(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    layers = {}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        reports = e2e[m["moves"]].get("workloads", sorted(cells))
        assert set(m["workloads"]) <= set(reports), m["name"]
        assert os.path.exists(os.path.join(
            ROOT, "perfbench", "metrics", f"{m['name']}.py"))
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for e in e2e.values():
        assert set(e.get("workloads", cells)) <= cells


@pytest.mark.parametrize("name", ["k1", "k2"])
def test_kernel_counts_name_their_trace_pattern(name):
    rec = harness.Record(window_s=1.0)
    k = rec.kernel(name)
    assert k.PATTERN and callable(k.work)
