"""Shared conv building blocks — counterpart of
``sparkdl_tpu/models/layers.py``.

Modules take NCHW tensors (channels_last in memory on the main path: a
permute of a contiguous NHWC tensor). Numerics follow the JAX package:
the conv runs in the model dtype (bf16 by default) with float32
parameters cast to it, BatchNorm runs in float32 on the conv output
with flax's formula, and the result is cast back.

Padding follows flax: ``"SAME"`` pads TF-style, with the odd pixel at
the end when the total is odd (a stride-2 3×3 conv on 32 px pads
``(0, 1)``), and SAME max-pooling pads with ``-inf``.

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
from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        if not train:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = x.to(torch.float32) - self.running_mean.view(shape)
            return y * mul.view(shape) + self.bias.view(shape)
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


def conv2d(x: torch.Tensor, conv: nn.Conv2d, padding: Padding,
           dtype: torch.dtype) -> torch.Tensor:
    """``conv``'s weights (and bias) applied in ``dtype``, with flax's
    padding: input and weights cast to ``dtype``, and the bias added to
    the ``dtype`` result, as ``nn.Conv(dtype=...)`` does."""
    x, pad = _pad(x.to(dtype), _resolve_pads(x, padding, conv.kernel_size,
                                             conv.stride))
    y = F.conv2d(x, conv.weight.to(dtype), stride=conv.stride, padding=pad,
                 groups=conv.groups)
    if conv.bias is not None:
        y = y + conv.bias.to(dtype).view(1, -1, 1, 1)
    return y


class ConvBN(nn.Module):
    """Conv (bias optional) + BatchNorm + optional ReLU — the
    ``conv2d_bn`` unit every zoo CNN is built from (ResNet50's convs
    carry biases)."""

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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = conv2d(x, self.conv, self.padding, self.dtype)
        y = self.bn(y, train).to(self.dtype)
        return F.relu(y) if self.relu else y


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
        y = self.bn(y, train).to(self.dtype)
        return F.relu(y) if self.relu else y


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
