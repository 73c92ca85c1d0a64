"""Shared conv building blocks — counterpart of
``sparkdl_tpu/models/layers.py`` — and, at the end, the transformer
pieces of ``models/siglip.py``, which the JAX package does not carry.

Modules take NCHW tensors (channels_last in memory on the main path: a
permute of a contiguous NHWC tensor). Numerics follow the JAX package:
the conv runs in the model dtype (bf16 by default) with float32
parameters cast to it, BatchNorm runs in float32 on the conv output
with flax's formula, and the result is cast back.

Padding follows flax: ``"SAME"`` pads TF-style, with the odd pixel at
the end when the total is odd (a stride-2 3×3 conv on 32 px pads
``(0, 1)``), and SAME max-pooling pads with ``-inf``.

On the card, in inference where no gradient is needed and the conv runs
in bf16, a conv unit's epilogue (the conv's bias, BatchNorm, the
residual of a ResNet bottleneck and the ReLU) is one launch of the op
``sparkdl_tpu_torch::conv_epilogue`` (``ops/epilogue.py``). Everywhere
else, the CPU included, it is the eager chain: ``conv2d`` with its bias,
``BatchNorm.forward``, the cast, the residual add and ``F.relu``. The
values are the same either way.

Every conv unit takes ``train`` (default False). In training, BatchNorm
normalizes with the batch's statistics and moves its running ones, as
flax's ``BatchNorm(use_running_average=False, momentum=0.9)`` does.
Inside :func:`synced_batch_stats` (the data-parallel train step) the
batch statistics are those of the global batch: each rank's mean and
mean of squares are averaged over the data group before use.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.ops import epilogue

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_pads(size: Sequence[int], window: Sequence[int],
              strides: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """Per spatial dim ``(lo, hi)`` padding of flax/TF ``"SAME"``."""
    pads = []
    for n, k, s in zip(size, window, strides):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def _resolve_pads(x: torch.Tensor, padding: Padding, window, strides):
    if padding == "SAME":
        return same_pads(x.shape[2:], window, strides)
    if padding == "VALID":
        return ((0, 0), (0, 0))
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def _pad(x: torch.Tensor, pads, value: float = 0.0):
    """(padded x, symmetric padding left for the op) — a symmetric pad
    goes to the op itself, an asymmetric one is applied here."""
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 == ph1 and pw0 == pw1:
        return x, (ph0, pw0)
    return F.pad(x, (pw0, pw1, ph0, ph1), value=value), (0, 0)


_SYNC = threading.local()


@contextlib.contextmanager
def synced_batch_stats(group, size: int):
    """Within the block, training BatchNorms on this thread average their
    batch statistics over ``group`` (``size`` ranks) with an autograd-
    aware all-reduce, so the statistics, and the gradient through them,
    are the global batch's (SyncBatchNorm semantics, flax's formula)."""
    prev = getattr(_SYNC, "group", None)
    _SYNC.group = (group, int(size))
    try:
        yield
    finally:
        _SYNC.group = prev


class BatchNorm(nn.Module):
    """BatchNorm in float32, flax's formula ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``: the running statistics in inference, the
    batch's in training (over N, H and W; the biased variance
    ``mean(x²) − mean(x)²`` clamped at 0), which also moves the running
    ones by ``0.9·running + 0.1·batch``. ``F.batch_norm(training=True)``
    is not used: it moves ``running_var`` by the unbiased variance."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def inference_terms(self):
        """``(mean, mul, offset)`` of the inference formula ``(x - mean) *
        mul + offset``: the running mean, ``rsqrt(running_var + eps) *
        scale`` and the offset."""
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return self.running_mean, mul, self.bias

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if not train:
            return epilogue.batchnorm(x, *self.inference_terms())
        x32 = x.to(torch.float32)
        mean, mean2 = batch_moments(x32)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean
                                    + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = x32 - mean.view(shape)
        return y * mul.view(shape) + self.bias.view(shape)


def batch_moments(x32: torch.Tensor):
    """Per channel ``(mean(x), mean(x²))`` over N, H and W of a float32
    NCHW tensor; averaged over the data group inside
    :func:`synced_batch_stats`."""
    moments = torch.stack([x32.mean(dim=(0, 2, 3)),
                           (x32 * x32).mean(dim=(0, 2, 3))])
    sync = getattr(_SYNC, "group", None)
    if sync is not None:
        from torch.distributed.nn.functional import all_reduce
        group, size = sync
        moments = all_reduce(moments, group=group) / size
    return moments[0], moments[1]


def keras_batch_moments(x: torch.Tensor, dims: Tuple[int, ...]):
    """Per channel ``(mean(x), mean((x - mean)²))`` over ``dims``, Keras
    3's moments (``jnp.mean`` then ``jnp.var``, the biased variance about
    the mean). Inside :func:`synced_batch_stats` both are the data
    group's: the mean is averaged over the group first, then each rank's
    squared deviations from it."""
    sync = getattr(_SYNC, "group", None)
    mean = x.mean(dim=dims, keepdim=True)
    if sync is not None:
        from torch.distributed.nn.functional import all_reduce
        group, size = sync
        mean = all_reduce(mean, group=group) / size
    d = x - mean
    var = (d * d).mean(dim=dims)
    if sync is not None:
        var = all_reduce(var, group=group) / size
    return mean.reshape(-1), var


def _conv(x: torch.Tensor, conv: nn.Conv2d, padding: Padding,
          dtype: torch.dtype) -> torch.Tensor:
    """``conv``'s weights applied in ``dtype``, without its bias."""
    x, pad = _pad(x.to(dtype), _resolve_pads(x, padding, conv.kernel_size,
                                             conv.stride))
    return F.conv2d(x, conv.weight.to(dtype), stride=conv.stride,
                    padding=pad, groups=conv.groups)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, padding: Padding,
           dtype: torch.dtype) -> torch.Tensor:
    """``conv``'s weights (and bias) applied in ``dtype``, with flax's
    padding: input and weights cast to ``dtype``, and the bias added to
    the ``dtype`` result, as ``nn.Conv(dtype=...)`` does."""
    y = _conv(x, conv, padding, dtype)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype).view(1, -1, 1, 1)
    return y


# devices on which a conv unit's inference epilogue is one call of the
# fused op. The CPU keeps the eager chain through conv2d and
# BatchNorm.forward, the functions perfbench's CPU tests patch to plant
# the faults its comparison must catch; the op's CPU implementation is
# the same chain, value for value
EPILOGUE_DEVICES = ("cuda",)


def _fuses(unit: nn.Module, x: torch.Tensor, train: bool,
           residual: Optional[torch.Tensor] = None) -> bool:
    """Whether ``unit`` (a :class:`ConvBN` or :class:`SeparableConvBN`)
    runs its epilogue as one call of the fused op: inference on an
    :data:`EPILOGUE_DEVICES` device in bf16, float32 BatchNorm, a bf16
    residual, and no gradient needed (the op has no autograd formula)."""
    bn = unit.bn
    return (not train and unit.dtype == torch.bfloat16
            and x.device.type in EPILOGUE_DEVICES
            and all(t.dtype == torch.float32 for t in (
                bn.weight, bn.bias, bn.running_mean, bn.running_var))
            and (residual is None or residual.dtype == torch.bfloat16)
            and not (torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, residual, *unit.parameters()))))


def _fused_epilogue(y: torch.Tensor, conv_bias, bn: BatchNorm, relu: bool,
                    residual: Optional[torch.Tensor]) -> torch.Tensor:
    """``relu(bn(y + bias).to(bf16) + residual)`` as one call of the op
    (``ops/epilogue.py``), on the bf16 conv output before its bias; the
    residual is brought to ``y``'s layout."""
    if residual is not None:
        residual = residual.contiguous(memory_format=(
            torch.channels_last if epilogue.channels_last(y)
            else torch.contiguous_format))
    bias = None if conv_bias is None else conv_bias.to(torch.bfloat16)
    return epilogue.conv_epilogue(y, bias, *bn.inference_terms(), residual,
                                  relu)


def _eager_epilogue(y: torch.Tensor, bn: BatchNorm, relu: bool,
                    dtype: torch.dtype, train: bool,
                    residual: Optional[torch.Tensor]) -> torch.Tensor:
    """``relu(bn(y).to(dtype) + residual)`` in eager ops on the biased
    conv output, with :class:`BatchNorm`'s own forward (the batch's
    statistics in training); counted as ``model.epilogue.eager`` on the
    card."""
    epilogue.count_eager(y)
    y = bn(y, train).to(dtype)
    if residual is not None:
        y = y + residual
    return F.relu(y) if relu else y


class ConvBN(nn.Module):
    """Conv (bias optional) + BatchNorm + optional ReLU — the
    ``conv2d_bn`` unit every zoo CNN is built from (ResNet50's convs
    carry biases). A ``residual`` passed to :meth:`forward` is added
    after BatchNorm, before the ReLU (a ResNet bottleneck's shortcut)."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Padding = "SAME", relu: bool = True,
                 bn_epsilon: float = 1e-3, use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.padding = padding
        self.relu = relu
        self.dtype = dtype
        self.conv = nn.Conv2d(in_features, features, tuple(kernel),
                              stride=tuple(strides), bias=use_bias)
        self.bn = BatchNorm(features, bn_epsilon)

    def forward(self, x: torch.Tensor, train: bool = False,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if _fuses(self, x, train, residual):
            y = _conv(x, self.conv, self.padding, self.dtype)
            return _fused_epilogue(y, self.conv.bias, self.bn, self.relu,
                                   residual)
        y = conv2d(x, self.conv, self.padding, self.dtype)
        return _eager_epilogue(y, self.bn, self.relu, self.dtype, train,
                               residual)


class SeparableConvBN(nn.Module):
    """Depthwise conv (``groups=C``, SAME) + pointwise 1×1 conv, both
    without bias, then BatchNorm (eps 1e-3) and an optional ReLU —
    Xception's separable_conv unit."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), relu: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.relu = relu
        self.dtype = dtype
        self.depthwise = nn.Conv2d(in_features, in_features, tuple(kernel),
                                   stride=tuple(strides),
                                   groups=in_features, bias=False)
        self.pointwise = nn.Conv2d(in_features, features, (1, 1),
                                   bias=False)
        self.bn = BatchNorm(features, 1e-3)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv2d(x, self.depthwise, "SAME", self.dtype)
        y = conv2d(y, self.pointwise, "SAME", self.dtype)
        if _fuses(self, x, train):
            return _fused_epilogue(y, None, self.bn, self.relu, None)
        return _eager_epilogue(y, self.bn, self.relu, self.dtype, train,
                               None)


def max_pool(x: torch.Tensor, window=(3, 3), strides=(2, 2),
             padding: Padding = "VALID") -> torch.Tensor:
    x, pad = _pad(x, _resolve_pads(x, padding, window, strides),
                  value=float("-inf"))
    return F.max_pool2d(x, window, strides, padding=pad)


def avg_pool(x: torch.Tensor, window=(3, 3), strides=(1, 1),
             padding: Padding = "SAME") -> torch.Tensor:
    """Average pooling that divides each window by its count of VALID
    elements (``count_include_pad=False``), as TF/Keras SAME pooling and
    the JAX package do."""
    pads = _resolve_pads(x, padding, window, strides)
    (ph0, ph1), (pw0, pw1) = pads
    if ph0 == ph1 and pw0 == pw1:
        return F.avg_pool2d(x, window, strides, padding=(ph0, pw0),
                            count_include_pad=False)
    # asymmetric: window sums over the zero-padded input divided by the
    # window's count of real elements
    ones = torch.ones_like(x[:, :1])
    sums = F.avg_pool2d(F.pad(x, (pw0, pw1, ph0, ph1)), window, strides)
    counts = F.avg_pool2d(F.pad(ones, (pw0, pw1, ph0, ph1)), window,
                          strides)
    return sums / counts


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] → [N, C], in the input dtype (a bf16 mean, as the JAX
    package's ``jnp.mean`` of a bf16 tensor)."""
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# transformer pieces (models/siglip.py): the token stream and every product
# in the model dtype (bf16), LayerNorm's and the softmax's statistics in
# float32
# ---------------------------------------------------------------------------

class LayerNorm(nn.Module):
    """LayerNorm over the last dim with float32 parameters, as
    :class:`BatchNorm` keeps its own. The statistics and the
    normalisation run in float32 inside ``F.layer_norm`` (its
    accumulation type for a bf16 input), with the scale and offset
    taken in the input's dtype (CUDA's ``layer_norm`` takes no float32
    parameters for a bf16 input), and the result is rounded once to
    it."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.weight.shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU with the tanh approximation (``gelu_pytorch_tanh``, flax's
    ``nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


# the fused backends attention may take on the card: never the math
# fallback, which would build every head's [N, N] scores in device memory
FUSED_ATTENTION = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                   "CUDNN_ATTENTION")
# sdpa_kernel sets process-wide flags: one attention call holds them at
# a time, so two threads running models never restore each other's
_SDPA_FLAGS = threading.Lock()


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """Softmax attention ``softmax(q kᵀ / √d) v`` of [B, H, Nq, d] queries
    over [B, H, N, d] keys and values (no mask), through
    ``F.scaled_dot_product_attention``: on the card limited to
    :data:`FUSED_ATTENTION`, so a shape, dtype or layout no fused kernel
    takes raises there rather than fall back; plain on the CPU. Counted
    as ``model.attention.calls`` on either device."""
    from sparkdl_tpu_torch.obs.registry import default_registry
    default_registry().counter("model.attention.calls").add()
    if q.device.type != "cuda":
        return F.scaled_dot_product_attention(q, k, v)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with _SDPA_FLAGS, sdpa_kernel([getattr(SDPBackend, b)
                                   for b in FUSED_ATTENTION]):
        return F.scaled_dot_product_attention(q, k, v)
