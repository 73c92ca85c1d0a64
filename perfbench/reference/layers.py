"""Plain float32 layers of the reference networks, in the Keras
Applications' terms: a Conv2D, its BatchNormalization and its ReLU as
one unit, TF's "same" padding, and average pooling that counts only the
real pixels of a window. Parameters come from a state dict under the
key names the program's zoo uses (``<prefix>.conv.weight``,
``<prefix>.bn.running_mean``, ...), so one seeded state dict feeds both.

``quant``, where given, is a :class:`Lower` precision for a control:
it rounds a conv's input and weights, and with ``values`` also every
other value the configuration keeps in its stated precision (bfloat16
in both networks: a conv's output, each unit's result, a residual sum,
the pooled features). What the configuration keeps in float32 (the
BatchNormalization arithmetic, the dense layer, the softmax) stays in
float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

State = Dict[str, torch.Tensor]


class Lower:
    """A precision below the configuration's: ``round`` maps a float32
    tensor to the float32 values the lower precision can hold; it
    rounds a conv's operands, and with ``values`` every other value the
    configuration keeps in bfloat16 too."""

    def __init__(self, round: Callable[[torch.Tensor], torch.Tensor],
                 values: bool):
        self.round, self.values = round, values

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return self.round(t)

    def value(self, t: torch.Tensor) -> torch.Tensor:
        return self.round(t) if self.values else t


Quant = Optional[Lower]


def same_pads(size: Sequence[int], kernel: Sequence[int],
              stride: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """TF "same": the total pad of each dim, the odd pixel at the end."""
    pads = []
    for n, k, s in zip(size, kernel, stride):
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def conv_bn(state: State, prefix: str, x: torch.Tensor, stride: int = 1,
            padding: str = "same", relu: bool = True, eps: float = 1e-3,
            quant: Quant = None) -> torch.Tensor:
    """Conv2D (with its bias when the state has one) -> BatchNorm with
    the running statistics -> optional ReLU, NCHW float32."""
    w = state[f"{prefix}.conv.weight"]
    b = state.get(f"{prefix}.conv.bias")
    if padding == "same":
        (t, bo), (le, r) = same_pads(x.shape[2:], w.shape[2:],
                                     (stride, stride))
        x = F.pad(x, (le, r, t, bo))
    if quant is not None:
        x, w = quant.operand(x), quant.operand(w)
    y = F.conv2d(x, w, b, stride=stride)
    if quant is not None:
        y = quant.value(y)
    mean = state[f"{prefix}.bn.running_mean"].view(1, -1, 1, 1)
    var = state[f"{prefix}.bn.running_var"].view(1, -1, 1, 1)
    gamma = state[f"{prefix}.bn.weight"].view(1, -1, 1, 1)
    beta = state[f"{prefix}.bn.bias"].view(1, -1, 1, 1)
    y = (y - mean) / torch.sqrt(var + eps) * gamma + beta
    y = F.relu(y) if relu else y
    return quant.value(y) if quant is not None else y


def conv_bn_shapes(prefix: str, cin: int, cout: int,
                   kernel: Tuple[int, int], bias: bool = False):
    """The (key, shape) pairs of one conv unit's parameters."""
    out = [(f"{prefix}.conv.weight", (cout, cin) + tuple(kernel))]
    if bias:
        out.append((f"{prefix}.conv.bias", (cout,)))
    out += [(f"{prefix}.bn.{k}", (cout,))
            for k in ("weight", "bias", "running_mean", "running_var")]
    return out


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 "same" average pooling that divides by the number of
    real pixels under the window (TF's and Keras' rule)."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def max_pool(x: torch.Tensor, pad: int = 0) -> torch.Tensor:
    """3x3 stride-2 max pooling over a zero-padded input (Keras'
    ZeroPadding2D then MaxPooling2D)."""
    if pad:
        x = F.pad(x, (pad, pad, pad, pad))
    return F.max_pool2d(x, 3, 2)


def dense(state: State, x: torch.Tensor):
    """The top's dense layer, in float32."""
    return F.linear(x, state["fc.weight"], state["fc.bias"])


def global_pool(x: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """[N, C, H, W] -> [N, C]: the mean the features are (in the
    configuration's precision)."""
    y = x.mean(dim=(2, 3))
    return quant.value(y) if quant is not None else y


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor (its largest magnitude onto
    e4m3's 448), back in float32: one step below the bfloat16 the
    configurations state."""
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


# the controls: float8 in place of bfloat16 on the convs' operands only
# (what a conv run as float8 GEMMs with bfloat16 around them would give),
# and on every bfloat16 value of the network
CONTROLS = {"fp8_operands": Lower(fp8_round, values=False),
            "fp8_values": Lower(fp8_round, values=True)}
