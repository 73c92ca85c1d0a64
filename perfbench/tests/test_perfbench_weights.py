"""The seeding rule of ``weights.py``: the two CNNs' weights as before,
bit for bit; a reference that declares its parameters' kinds seeded by
them; a key no rule names refused; the controls' readings on a cell of
such a reference, added as new files only."""

import json
import math
import os
import re

import pytest
import torch

from perfbench import control, harness, weights
from perfbench.inputs import generator
from conftest import add_tiny_cells

# -- the seeding before a reference could declare kinds, kept verbatim as
# the oracle of the two CNNs' weights


def _kind(key: str) -> str:
    """Which range a non-kernel parameter is drawn from."""
    if key.endswith("bn.weight"):
        return "gamma"
    if key.endswith("running_var"):
        return "var"
    if key.endswith("running_mean"):
        return "mean"
    if key.endswith("bn.bias"):
        return "beta"
    return "bias"


def make_state(shapes, seed: int, device, scheme: dict):
    """``shapes``: [(key, shape)] as the reference lists them;
    ``scheme``: a configuration's ``weights``."""
    kernels = [(k, s) for k, s in shapes
               if k.endswith(".conv.weight") or k == "fc.weight"]
    total = sum(math.prod(s) for _, s in kernels)
    gen = generator(seed, 0, device)
    draw = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for key, shape in kernels:
        n = math.prod(shape)
        fan_in = n // shape[0]
        state[key] = draw[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)
        at += n

    rest = [(k, s) for k, s in shapes if k not in state]
    total = sum(math.prod(s) for _, s in rest)
    gen = generator(seed, 2, device)
    uniform = torch.rand(total, generator=gen, device=device)
    normal = torch.randn(total, generator=gen, device=device)
    g_lo, g_hi = scheme["bn_gamma"]
    v_lo, v_hi = scheme["bn_var"]
    std = {"mean": scheme["bn_mean_std"], "beta": scheme["bn_beta_std"],
           "bias": scheme["bias_std"]}
    at = 0
    for key, shape in rest:
        n = math.prod(shape)
        u, z = uniform[at:at + n].view(shape), normal[at:at + n].view(shape)
        at += n
        kind = _kind(key)
        if kind == "gamma":
            base = next((float(v) for p, v in
                         scheme.get("bn_scale", {}).items()
                         if re.fullmatch(p, key)), 1.0)
            state[key] = base * (g_lo + (g_hi - g_lo) * u)
        elif kind == "var":
            state[key] = v_lo + (v_hi - v_lo) * u
        else:
            state[key] = z * std[kind]
    return state


# -- a reference that declares its kinds: a pre-norm transformer block

TINYVIT = '''"""A pre-norm transformer block over 8x8 patches of a 32x32 image,
a depthwise conv on the token grid, and attention pooling by a probe
token: the parameter kinds a transformer declares."""

import math

import torch
import torch.nn.functional as F

INPUT_HW = (32, 32)
PATCH = 8
D = 128


def param_shapes(d=D):
    tokens = (INPUT_HW[0] // PATCH) * (INPUT_HW[1] // PATCH)
    return [
        ("patch.weight", (d, 3, PATCH, PATCH)), ("patch.bias", (d,)),
        ("pos_embedding", (1, tokens, d)),
        ("block.ln1.weight", (d,)), ("block.ln1.bias", (d,)),
        ("block.attn.in_proj.weight", (3 * d, d)),
        ("block.attn.in_proj.bias", (3 * d,)),
        ("block.attn.out.weight", (d, d)), ("block.attn.out.bias", (d,)),
        ("block.dw.weight", (d, 1, 3, 3)),
        ("block.ln2.weight", (d,)), ("block.ln2.bias", (d,)),
        ("block.fc1.weight", (4 * d, d)), ("block.fc1.bias", (4 * d,)),
        ("block.fc2.weight", (d, 4 * d)), ("block.fc2.bias", (d,)),
        ("probe", (1, 1, d)),
        ("norm.weight", (d,)), ("norm.bias", (d,)),
    ]


def param_kinds():
    """The keys the suffix rule would not seed as they are: the ``.bias``
    keys of linear layers it does."""
    kinds = {"patch.weight": "kernel", "block.dw.weight": "kernel",
             "pos_embedding": "embedding", "probe": "embedding"}
    for norm in ("block.ln1", "block.ln2", "norm"):
        kinds[f"{norm}.weight"] = "gamma"
        kinds[f"{norm}.bias"] = "beta"
    for lin in ("attn.in_proj", "attn.out", "fc1", "fc2"):
        kinds[f"block.{lin}.weight"] = "kernel"
    return kinds


def _op(f, x, w, quant, *args, **kw):
    if quant is not None:
        x, w = quant.operand(x), quant.operand(w)
    y = f(x, w, *args, **kw)
    return quant.value(y) if quant is not None else y


def forward(state, x, quant=None):
    """uint8 [N, 32, 32, 3] -> float32 [N, D]."""
    s = state
    h = x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
    h = _op(F.conv2d, h, s["patch.weight"], quant, s["patch.bias"],
            stride=PATCH)
    n, d, gh, gw = h.shape
    h = h.flatten(2).transpose(1, 2) + s["pos_embedding"]
    a = F.layer_norm(h, (d,), s["block.ln1.weight"], s["block.ln1.bias"],
                     eps=1e-6)
    q, k, v = _op(F.linear, a, s["block.attn.in_proj.weight"], quant,
                  s["block.attn.in_proj.bias"]).chunk(3, dim=-1)
    att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(d), dim=-1)
    h = h + _op(F.linear, att @ v, s["block.attn.out.weight"], quant,
                s["block.attn.out.bias"])
    grid = h.transpose(1, 2).reshape(n, d, gh, gw)
    h = h + _op(F.conv2d, grid, s["block.dw.weight"], quant, padding=1,
                groups=d).flatten(2).transpose(1, 2)
    m = F.layer_norm(h, (d,), s["block.ln2.weight"], s["block.ln2.bias"],
                     eps=1e-6)
    m = F.gelu(_op(F.linear, m, s["block.fc1.weight"], quant,
                   s["block.fc1.bias"]), approximate="tanh")
    h = h + _op(F.linear, m, s["block.fc2.weight"], quant,
                s["block.fc2.bias"])
    h = F.layer_norm(h, (d,), s["norm.weight"], s["norm.bias"], eps=1e-6)
    pool = torch.softmax(s["probe"] @ h.transpose(1, 2) / math.sqrt(d),
                         dim=-1) @ h
    return pool[:, 0]
'''

# no BatchNorm: the scheme states only what the kinds above read
SCHEME = {"bn_gamma": [0.8, 1.2], "bn_beta_std": 0.1, "bias_std": 0.05,
          "embedding_std": 0.02,
          "bn_scale": {"norm\\.weight": 0.5}}
CONFIG = {"name": "tinyvit", "model": "TinyViT", "reference": "tinyvit",
          "input_hw": [32, 32], "featurize": True, "output": "features",
          "output_width": 128, "weights": SCHEME}
MIX = {"kind": "packed", "format": "rgb", "src_hw": [48, 48], "rows": 4,
       "partitions": 2, "batch": 2}
CELL = "tinyvit.tiny_rgb48"


@pytest.fixture(scope="module")
def vit(tmp_path_factory):
    """(manifest path, the fixture's reference module) of a copy of the
    benchmark with the fixture's configuration and cell added as new
    files only."""
    root = str(tmp_path_factory.mktemp("bench"))
    path = add_tiny_cells(root)
    bench = os.path.join(root, "perfbench")
    files = {"reference/tinyvit.py": TINYVIT,
             "configs/tinyvit.json": json.dumps(CONFIG),
             "traffic/tiny_rgb48.json": json.dumps(MIX),
             f"limits/{CELL}.json": json.dumps(
                 {"numbers": {"out_rel_err_max": {"limit": 0.05}}})}
    for name, text in files.items():
        with open(os.path.join(bench, name), "w") as f:
            f.write(text)
    with open(path) as f:
        manifest = json.load(f)
    manifest["configs"].append({
        "name": "tinyvit", "source": "a fixture of the seeding tests",
        "file": "perfbench/configs/tinyvit.json", "reduced": [],
        "why": "a reference that declares its parameters' kinds"})
    manifest["workloads"].append({
        "name": CELL, "config": "tinyvit", "traffic": "tiny_rgb48",
        "chips": 1, "why": "a tiny cell for the CPU"})
    with open(path, "w") as f:
        json.dump(manifest, f)
    return path, harness.resolve(CELL, path).reference()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("workload", ["inceptionv3.packed_yuv420_150",
                                      "resnet50.packed_rgb256"])
def test_the_cnns_weights_are_the_parents_bit_for_bit(workload, seed):
    cell = harness.resolve(workload)
    want = make_state(cell.reference().param_shapes(), seed, "cpu",
                      cell.config["weights"])
    got = weights.for_cell(cell, seed, "cpu")
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def test_declaring_the_suffix_rules_kinds_changes_nothing():
    """A reference that declares for every key the kind its suffix
    gives is seeded alike: the declaration and the draw order agree."""
    cell = harness.resolve("resnet50.packed_rgb256")
    shapes = cell.reference().param_shapes()
    kinds = weights._kinds_of(shapes)
    assert set(kinds.values()) == {"kernel", "gamma", "var", "mean",
                                   "beta", "bias"}
    scheme = cell.config["weights"]
    plain = weights.make_state(shapes, 5, "cpu", scheme)
    declared = weights.make_state(shapes, 5, "cpu", scheme, kinds)
    assert all(torch.equal(plain[k], declared[k]) for k in plain)


def test_a_declared_reference_is_seeded_by_its_kinds(vit):
    _, ref = vit
    d = 1024   # wide enough that every kind's sample statistics settle
    shapes = ref.param_shapes(d=d)
    kinds = ref.param_kinds()
    state = weights.make_state(shapes, 7, "cpu", SCHEME, kinds)
    assert set(state) == {k for k, _ in shapes}
    fan_in = {"patch.weight": 3 * 8 * 8, "block.dw.weight": 9,
              "block.attn.in_proj.weight": d, "block.attn.out.weight": d,
              "block.fc1.weight": d, "block.fc2.weight": 4 * d}
    for key, fan in fan_in.items():
        assert state[key].std().item() == pytest.approx(
            math.sqrt(2.0 / fan), rel=0.05), key
    for key in ("block.ln1.weight", "block.ln2.weight", "norm.weight"):
        base = 0.5 if key == "norm.weight" else 1.0
        g = state[key] / base
        assert g.min().item() >= 0.8 and g.max().item() <= 1.2, key
        assert g.min().item() < 0.82 and g.max().item() > 1.18, key
    betas = torch.cat([state[k] for k in ("block.ln1.bias",
                                          "block.ln2.bias", "norm.bias")])
    biases = torch.cat([state[k] for k, _ in shapes
                        if k.endswith(".bias") and k not in kinds])
    embeddings = torch.cat([state["pos_embedding"].flatten(),
                            state["probe"].flatten()])
    for values, std in ((betas, 0.1), (biases, 0.05), (embeddings, 0.02)):
        assert values.std().item() == pytest.approx(std, rel=0.05)
        assert abs(values.mean().item()) < 0.1 * std


@pytest.mark.parametrize("shapes, kinds, match", [
    ([("fc.weight", (4, 3)), ("blocks.0.attn.qkv.weight", (9, 3))], None,
     "blocks.0.attn.qkv.weight"),
    ([("head.weight", (4, 3))], {"head.weight": "matrix"},
     "head.weight.*matrix"),
    ([("fc.weight", (4, 3))], {"fc.scale": "gamma"}, "fc.scale"),
], ids=["undeclared", "unknown-kind", "unlisted-key"])
def test_a_key_no_rule_names_is_refused(shapes, kinds, match):
    with pytest.raises(ValueError, match=match):
        weights.make_state(shapes, 0, "cpu", SCHEME, kinds)


def test_the_controls_read_a_declared_cell(vit):
    """``control.py`` seeds the fixture's cell through the one seeding
    path and reads each control on it."""
    path, _ = vit
    out = control.main(["--workload", CELL, "--seeds", "1",
                        "3000000019"], device="cpu", manifest=path)
    assert len(out) == 2
    for line in out:
        numbers = [line["limit"], line["fp8_operands"], line["fp8_values"]]
        assert all(math.isfinite(v) and v > 0 for v in numbers), line
