"""SigLIP so400m/14 at 384's vision tower (Zhai et al. 2023,
arXiv:2303.15343; the so400m shape, arXiv:2305.13035) in plain float32
PyTorch, from ``google/siglip-so400m-patch14-384``'s ``vision_config``:
the equations of the port's tests' reference (``tests/siglip_reference.py``),
and only what the benchmark asks besides: ``quant`` (a control), the
published widths in :func:`param_shapes` and every key's kind in
:func:`param_kinds`.

uint8 RGB [N, 384, 384, 3] → x / 127.5 − 1 → a 14×14 stride-14 ``valid``
conv 3 → 1152 with bias (27 × 27 = 729 tokens; the last 6 pixel rows and
columns dropped) plus the position embedding → 27 pre-LayerNorm blocks,
``h += out_proj(attn(LN1(h)))`` then ``h += fc2(gelu_tanh(fc1(LN2(h))))``,
LayerNorm eps 1e-6, attention an explicit ``softmax(q kᵀ / √72) v`` over
16 heads with biases on q, k, v and out, MLP 1152 → 4304 → 1152 →
``post_layernorm`` → the attention-pooling head (a probe token through
the fused ``in_proj`` and ``out_proj``, then ``a + mlp(LN(a))``): the
1152-d features. Keys are Hugging Face's without ``vision_model.``.

``quant``, where given, rounds every product's operands (the patch
conv's, each dense layer's, q and k of the scores, the probabilities and
v of the mix), and with ``values`` every value the configuration keeps in
bfloat16 (the token stream and each residual sum, each LayerNorm's
output, each dense layer's output and GELU's, the attention's output, the
features). LayerNorm's and the softmax's arithmetic stay float32.

Departures from the published model: none in the network. The program's
infeed resizes with K1's anti-aliased bilinear filter where Hugging
Face's processor resizes bicubic; the reference is given the same uint8
input as the program, so that belongs to the traffic.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

HIDDEN, LAYERS, HEADS, MLP, PATCH, IMAGE = 1152, 27, 16, 4304, 14, 384
EPS = 1e-6
INPUT_HW = (IMAGE, IMAGE)
FEATURES = HIDDEN


def param_shapes(hidden=HIDDEN, layers=LAYERS, mlp=MLP, patch=PATCH,
                 image=IMAGE):
    """[(key, shape)] in the model's order."""
    tokens = (image // patch) ** 2

    def ln(p):
        return [(f"{p}.weight", (hidden,)), (f"{p}.bias", (hidden,))]

    def linear(p, n_out, n_in):
        return [(f"{p}.weight", (n_out, n_in)), (f"{p}.bias", (n_out,))]

    def mlp_(p):
        return linear(f"{p}.fc1", mlp, hidden) + linear(f"{p}.fc2", hidden,
                                                        mlp)

    out = [("embeddings.patch_embedding.weight", (hidden, 3, patch, patch)),
           ("embeddings.patch_embedding.bias", (hidden,)),
           ("embeddings.position_embedding.weight", (tokens, hidden))]
    for i in range(layers):
        p = f"encoder.layers.{i}"
        out += ln(f"{p}.layer_norm1")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += linear(f"{p}.self_attn.{proj}", hidden, hidden)
        out += ln(f"{p}.layer_norm2") + mlp_(f"{p}.mlp")
    out += ln("post_layernorm")
    out += [("head.probe", (1, 1, hidden)),
            ("head.attention.in_proj_weight", (3 * hidden, hidden)),
            ("head.attention.in_proj_bias", (3 * hidden,))]
    out += linear("head.attention.out_proj", hidden, hidden)
    return out + ln("head.layernorm") + mlp_("head.mlp")


def param_kinds(**widths):
    """Every key's kind for ``perfbench/weights.py``: the patch conv's,
    the dense layers' and ``in_proj``'s weights are kernels; LayerNorm's
    scales and offsets are ``gamma`` and ``beta``; the position embedding
    and the probe are ``embedding``; every other bias is ``bias``."""
    norms = ("layer_norm1", "layer_norm2", "post_layernorm", "layernorm")
    kinds = {}
    for key, shape in param_shapes(**widths):
        owner, _, leaf = key.rpartition(".")
        if owner.rpartition(".")[2] in norms:
            kinds[key] = "gamma" if leaf == "weight" else "beta"
        elif key in ("embeddings.position_embedding.weight", "head.probe"):
            kinds[key] = "embedding"
        elif len(shape) > 1:
            kinds[key] = "kernel"
        else:
            kinds[key] = "bias"
    return kinds


@contextlib.contextmanager
def _tf32_off(device):
    if device.type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _op(quant, t):
    return t if quant is None else quant.operand(t)


def _val(quant, t):
    return t if quant is None else quant.value(t)


def _ln(state, p, h, quant):
    return _val(quant, F.layer_norm(h, h.shape[-1:], state[f"{p}.weight"],
                                    state[f"{p}.bias"], EPS))


def _linear(state, p, h, quant):
    return _val(quant, F.linear(_op(quant, h),
                                _op(quant, state[f"{p}.weight"]),
                                state[f"{p}.bias"]))


def _mlp(state, p, h, quant):
    h = _val(quant, F.gelu(_linear(state, f"{p}.fc1", h, quant),
                           approximate="tanh"))
    return _linear(state, f"{p}.fc2", h, quant)


def _heads(h, heads):
    n, t, _ = h.shape
    return h.reshape(n, t, heads, -1).transpose(1, 2)


def _attend(q, k, v, heads, quant):
    """[N, Tq, hidden] queries over [N, T, hidden] keys and values."""
    q, k, v = (_heads(t, heads) for t in (q, k, v))
    scores = torch.matmul(_op(quant, q), _op(quant, k).transpose(-1, -2)) \
        * q.shape[-1] ** -0.5
    o = torch.matmul(_op(quant, torch.softmax(scores, dim=-1)),
                     _op(quant, v))
    n, _, tq, _ = o.shape
    return _val(quant, o.transpose(1, 2).reshape(n, tq, -1))


def forward(state, x: torch.Tensor, quant=None,
            heads: int = HEADS) -> torch.Tensor:
    """uint8 [N, H, W, 3] → float32 features [N, hidden]."""
    layers = sum(k.endswith(".layer_norm1.weight") for k in state)
    with _tf32_off(x.device):
        h = x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
        w = state["embeddings.patch_embedding.weight"]
        h = _val(quant, F.conv2d(_op(quant, h), _op(quant, w),
                                 state["embeddings.patch_embedding.bias"],
                                 stride=w.shape[-1]))
        h = h.flatten(2).transpose(1, 2)
        h = _val(quant, h + state["embeddings.position_embedding.weight"])
        for i in range(layers):
            p = f"encoder.layers.{i}"
            y = _ln(state, f"{p}.layer_norm1", h, quant)
            a = _attend(*(_linear(state, f"{p}.self_attn.{n}_proj", y, quant)
                          for n in "qkv"), heads, quant)
            h = _val(quant, h + _linear(state, f"{p}.self_attn.out_proj", a,
                                        quant))
            y = _ln(state, f"{p}.layer_norm2", h, quant)
            h = _val(quant, h + _mlp(state, f"{p}.mlp", y, quant))
        h = _ln(state, "post_layernorm", h, quant)
        w = state["head.attention.in_proj_weight"]
        b = state["head.attention.in_proj_bias"]
        d = h.shape[-1]
        probe = state["head.probe"].expand(h.shape[0], -1, -1)
        a = _attend(
            _val(quant, F.linear(_op(quant, probe), _op(quant, w[:d]),
                                 b[:d])),
            _val(quant, F.linear(_op(quant, h), _op(quant, w[d:2 * d]),
                                 b[d:2 * d])),
            _val(quant, F.linear(_op(quant, h), _op(quant, w[2 * d:]),
                                 b[2 * d:])), heads, quant)
        a = _linear(state, "head.attention.out_proj", a, quant)
        a = _val(quant, a + _mlp(state, "head.mlp",
                                 _ln(state, "head.layernorm", a, quant),
                                 quant))
        return a[:, 0]
