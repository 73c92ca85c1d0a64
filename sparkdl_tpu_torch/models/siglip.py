"""SigLIP so400m/14 at 384 (Zhai et al. 2023, arXiv:2303.15343; the
so400m shape of Alabdulmohsin et al. 2023, arXiv:2305.13035): the vision
tower as a featurizer, from ``google/siglip-so400m-patch14-384``'s
``vision_config``. The JAX package has no counterpart; the port's tests
hold it to the plain reference ``tests/siglip_reference.py``.

* Patch embedding: a 14×14 stride-14 ``valid`` conv 3 → 1152 with bias
  (384 px → 27 × 27 = 729 tokens; the last 6 pixel rows and columns are
  dropped), plus a learned (729, 1152) position embedding.
* 27 pre-LayerNorm blocks: ``x += out_proj(MHA(LN1(x)))``, then ``x +=
  fc2(gelu_tanh(fc1(LN2(x))))``; 16 heads of 72 with biases on q, k, v
  and out; MLP 1152 → 4304 → 1152; LayerNorm eps 1e-6.
* ``post_layernorm``, then the attention-pooling (MAP) head: a probe
  token attends over the tokens (``nn.MultiheadAttention``'s fused
  ``in_proj``), and ``h = attn + mlp(LN(attn))`` is the 1152-d feature.

The parameter keys are Hugging Face's ``SiglipVisionModel`` keys without
their ``vision_model.`` prefix. The token stream, every product and
every activation are in ``dtype`` (bf16 in the zoo); LayerNorm and the
softmax keep float32 statistics (``models/layers.py``). Attention goes
through ``layers.attention``: on the card a fused kernel or an error.
Armed (``obs/trace.py``), inside the runner's ``card.compute`` each
block records the card spans ``card.attention`` (LN1, the projections,
the attention and its residual add) and ``card.mlp`` (LN2, fc1, GELU,
fc2 and its residual add). The model has no classifier.
"""

from __future__ import annotations

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import LayerNorm, attention, gelu_tanh
from sparkdl_tpu_torch.obs.trace import card_span

HIDDEN, LAYERS, HEADS, MLP_WIDTH, PATCH, IMAGE = 1152, 27, 16, 4304, 14, 384
EPS = 1e-6


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, N, H·d] → [B, H, N, d] (a view)."""
    b, n, _ = x.shape
    return x.view(b, n, heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, d] → [B, N, H·d]."""
    b, _, n, _ = x.shape
    return x.transpose(1, 2).reshape(b, n, -1)


class Embeddings(nn.Module):
    def __init__(self, hidden: int, patch: int, image: int,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.patch_embedding = nn.Conv2d(3, hidden, patch, stride=patch,
                                         dtype=dtype)
        self.position_embedding = nn.Embedding((image // patch) ** 2,
                                               hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Float NCHW [B, 3, H, W] → tokens [B, N, hidden]."""
        y = self.patch_embedding(x.to(self.dtype))
        # a channels_last [B, C, h, w] is already [B, h·w, C] in memory
        tokens = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1])
        return tokens + self.position_embedding.weight


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden, dtype=dtype)
        self.k_proj = nn.Linear(hidden, hidden, dtype=dtype)
        self.v_proj = nn.Linear(hidden, hidden, dtype=dtype)
        self.out_proj = nn.Linear(hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_split_heads(p(x), self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(_merge_heads(attention(q, k, v)))


class MLP(nn.Module):
    def __init__(self, hidden: int, mlp: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp, dtype=dtype)
        self.fc2 = nn.Linear(mlp, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu_tanh(self.fc1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, mlp: int,
                 dtype: torch.dtype):
        super().__init__()
        self.layer_norm1 = LayerNorm(hidden, EPS)
        self.self_attn = Attention(hidden, heads, dtype)
        self.layer_norm2 = LayerNorm(hidden, EPS)
        self.mlp = MLP(hidden, mlp, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with card_span("card.attention"):
            x = x + self.self_attn(self.layer_norm1(x))
        with card_span("card.mlp"):
            x = x + self.mlp(self.layer_norm2(x))
        return x


class Encoder(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int, mlp: int,
                 dtype: torch.dtype):
        super().__init__()
        self.layers = nn.ModuleList(EncoderLayer(hidden, heads, mlp, dtype)
                                    for _ in range(layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class PoolingAttention(nn.Module):
    """``nn.MultiheadAttention(hidden, heads, batch_first=True)``'s
    parameters (a fused ``in_proj`` of q, k and v, and ``out_proj``),
    computed through ``layers.attention``."""

    def __init__(self, hidden: int, heads: int, dtype: torch.dtype):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * hidden, hidden,
                                                       dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * hidden,
                                                     dtype=dtype))
        self.out_proj = nn.Linear(hidden, hidden, dtype=dtype)

    def forward(self, query: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        d = query.shape[-1]
        w, b = self.in_proj_weight, self.in_proj_bias
        q = _split_heads(nn.functional.linear(query, w[:d], b[:d]),
                         self.heads)
        kv = nn.functional.linear(x, w[d:], b[d:])
        k = _split_heads(kv[..., :d], self.heads)
        v = _split_heads(kv[..., d:], self.heads)
        return self.out_proj(_merge_heads(attention(q, k, v)))


class PoolingHead(nn.Module):
    """The multihead attention-pooling head (``SiglipMultiheadAttention
    PoolingHead``): [B, N, hidden] → [B, hidden]."""

    def __init__(self, hidden: int, heads: int, mlp: int,
                 dtype: torch.dtype):
        super().__init__()
        self.probe = nn.Parameter(torch.empty(1, 1, hidden, dtype=dtype))
        self.attention = PoolingAttention(hidden, heads, dtype)
        self.layernorm = LayerNorm(hidden, EPS)
        self.mlp = MLP(hidden, mlp, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attention(self.probe.expand(x.shape[0], -1, -1), x)
        h = h + self.mlp(self.layernorm(h))
        return h[:, 0]


class SigLIP(nn.Module):
    """Float NCHW [B, 3, image, image] in [-1, 1] → [B, hidden] float32
    features (the head's ``dtype`` output, as the CNNs emit theirs). The
    widths default to so400m/14 at 384."""

    def __init__(self, hidden: int = HIDDEN, layers: int = LAYERS,
                 heads: int = HEADS, mlp: int = MLP_WIDTH,
                 patch: int = PATCH,
                 image: int = IMAGE, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.embeddings = Embeddings(hidden, patch, image, dtype)
        self.encoder = Encoder(hidden, layers, heads, mlp, dtype)
        self.post_layernorm = LayerNorm(hidden, EPS)
        self.head = PoolingHead(hidden, heads, mlp, dtype)

    def forward(self, x: torch.Tensor,
                features_only: bool = True) -> torch.Tensor:
        if not features_only:
            raise ValueError("SigLIP has no classifier: only its features "
                             "(features_only=True)")
        h = self.post_layernorm(self.encoder(self.embeddings(x)))
        return self.head(h).to(torch.float32)
