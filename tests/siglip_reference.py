"""The plain reference of SigLIP so400m/14 at 384's vision tower (Zhai et
al. 2023, arXiv:2303.15343; the so400m shape, arXiv:2305.13035), in
float32 PyTorch, written from ``google/siglip-so400m-patch14-384``'s
``vision_config`` and Hugging Face's ``SiglipVisionModel``. It imports
nothing of the port and nothing of JAX; the widths are arguments that
default to the published ones, and the depth, the widths and the token
count of :func:`forward` are read off the state dict.

uint8 RGB [N, H, W, 3] → x / 127.5 − 1 (SigLIP's rescale, mean 0.5 and
std 0.5) → a patch × patch stride-patch ``valid`` conv with bias (the
pixels past the last whole patch are dropped) → tokens [N, T, hidden] plus
the position embedding → ``layers`` pre-LayerNorm blocks, each ``h +=
out_proj(attn(LN1(h)))`` then ``h += fc2(gelu_tanh(fc1(LN2(h))))``,
LayerNorm eps 1e-6, attention an explicit ``softmax(q kᵀ / √d) v`` over
``heads`` heads with biases on q, k, v and out → ``post_layernorm`` → the
attention-pooling head: the probe token's attention over the tokens
through the fused ``in_proj`` (q, then k, then v rows) and ``out_proj``,
then ``a + mlp(LN(a))``, the [N, hidden] features. Keys are Hugging
Face's without the ``vision_model.`` prefix.

Departures from the published model: none in the network. The program's
infeed resizes with an anti-aliased bilinear filter where Hugging Face's
processor resizes bicubic; both sides of every comparison are given the
same uint8 input, so that belongs to the traffic, not to the model.
On the card, TF32 is off while :func:`forward` runs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

HIDDEN, LAYERS, HEADS, MLP, PATCH, IMAGE = 1152, 27, 16, 4304, 14, 384
EPS = 1e-6


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


def _ln(state, p, h):
    return F.layer_norm(h, h.shape[-1:], state[f"{p}.weight"],
                        state[f"{p}.bias"], EPS)


def _linear(state, p, h):
    return F.linear(h, state[f"{p}.weight"], state[f"{p}.bias"])


def _mlp(state, p, h):
    h = F.gelu(_linear(state, f"{p}.fc1", h), approximate="tanh")
    return _linear(state, f"{p}.fc2", h)


def _heads(h, heads):
    n, t, _ = h.shape
    return h.reshape(n, t, heads, -1).transpose(1, 2)


def _attend(q, k, v, heads):
    """[N, Tq, hidden] queries over [N, T, hidden] keys and values."""
    q, k, v = (_heads(t, heads) for t in (q, k, v))
    scores = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    o = torch.matmul(torch.softmax(scores, dim=-1), v)
    n, _, tq, _ = o.shape
    return o.transpose(1, 2).reshape(n, tq, -1)


def forward(state, x: torch.Tensor, heads: int = HEADS) -> torch.Tensor:
    """uint8 [N, H, W, 3] → float32 features [N, hidden]."""
    layers = sum(k.endswith(".layer_norm1.weight") for k in state)
    with _tf32_off(x.device):
        h = x.permute(0, 3, 1, 2).to(torch.float32) / 127.5 - 1.0
        w = state["embeddings.patch_embedding.weight"]
        h = F.conv2d(h, w, state["embeddings.patch_embedding.bias"],
                     stride=w.shape[-1])
        h = h.flatten(2).transpose(1, 2)
        h = h + state["embeddings.position_embedding.weight"]
        for i in range(layers):
            p = f"encoder.layers.{i}"
            y = _ln(state, f"{p}.layer_norm1", h)
            a = _attend(*(_linear(state, f"{p}.self_attn.{n}_proj", y)
                          for n in "qkv"), heads)
            h = h + _linear(state, f"{p}.self_attn.out_proj", a)
            y = _ln(state, f"{p}.layer_norm2", h)
            h = h + _mlp(state, f"{p}.mlp", y)
        h = _ln(state, "post_layernorm", h)
        w = state["head.attention.in_proj_weight"]
        b = state["head.attention.in_proj_bias"]
        d = h.shape[-1]
        probe = state["head.probe"].expand(h.shape[0], -1, -1)
        a = _attend(F.linear(probe, w[:d], b[:d]),
                    F.linear(h, w[d:2 * d], b[d:2 * d]),
                    F.linear(h, w[2 * d:], b[2 * d:]), heads)
        a = _linear(state, "head.attention.out_proj", a)
        a = a + _mlp(state, "head.mlp", _ln(state, "head.layernorm", a))
        return a[:, 0]
