"""InceptionV3 in PyTorch — counterpart of
``sparkdl_tpu/models/inception.py`` (stem → 3×block-A (35×35) →
reduction-A → 4×block-B (17×17) → reduction-B → 2×block-C (8×8) → global
average pool (2048-d featurize point) → logits).

Every submodule carries the name flax gives its counterpart
(``ConvBN_<i>`` in creation order, ``InceptionBlockA_<i>``, ...), so the
weight bridge (``models/convert.py``) is a name mapping. The convs go to
``F.conv2d`` (cuDNN on the card), as the JAX package left them to XLA.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    ConvBN,
    avg_pool,
    global_avg_pool,
    max_pool,
)


def _add_convs(module: nn.Module, dtype: torch.dtype,
               specs: Sequence[Tuple]) -> None:
    """Register ``ConvBN_0..`` on ``module`` from ``(in, out, kernel[,
    strides[, padding]])`` specs, in flax's creation order."""
    for i, (cin, cout, kernel, *rest) in enumerate(specs):
        strides = rest[0] if rest else (1, 1)
        padding = rest[1] if len(rest) > 1 else "SAME"
        module.add_module(f"ConvBN_{i}", ConvBN(
            cin, cout, kernel, strides=strides, padding=padding,
            dtype=dtype))


_S2 = (2, 2)


class InceptionBlockA(nn.Module):
    """35×35 mixed block: 1x1 / 5x5 / double-3x3 / pool branches."""

    def __init__(self, in_features: int, pool_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = in_features
        _add_convs(self, dtype, [
            (c, 64, (1, 1)),
            (c, 48, (1, 1)), (48, 64, (5, 5)),
            (c, 64, (1, 1)), (64, 96, (3, 3)), (96, 96, (3, 3)),
            (c, pool_features, (1, 1)),
        ])
        self.out_features = 64 + 64 + 96 + pool_features

    def forward(self, x):
        b1 = self.ConvBN_0(x)
        b5 = self.ConvBN_2(self.ConvBN_1(x))
        b3 = self.ConvBN_5(self.ConvBN_4(self.ConvBN_3(x)))
        bp = self.ConvBN_6(avg_pool(x))
        return torch.cat([b1, b5, b3, bp], dim=1)


class ReductionA(nn.Module):
    """35×35 → 17×17 (keras mixed3)."""

    def __init__(self, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = in_features
        _add_convs(self, dtype, [
            (c, 384, (3, 3), _S2, "VALID"),
            (c, 64, (1, 1)), (64, 96, (3, 3)),
            (96, 96, (3, 3), _S2, "VALID"),
        ])
        self.out_features = 384 + 96 + c

    def forward(self, x):
        b3 = self.ConvBN_0(x)
        bd = self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x)))
        return torch.cat([b3, bd, max_pool(x)], dim=1)


class InceptionBlockB(nn.Module):
    """17×17 mixed block with factorized 7×7 convs."""

    def __init__(self, in_features: int, c7: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = in_features
        _add_convs(self, dtype, [
            (c, 192, (1, 1)),
            (c, c7, (1, 1)), (c7, c7, (1, 7)), (c7, 192, (7, 1)),
            (c, c7, (1, 1)), (c7, c7, (7, 1)), (c7, c7, (1, 7)),
            (c7, c7, (7, 1)), (c7, 192, (1, 7)),
            (c, 192, (1, 1)),
        ])
        self.out_features = 4 * 192

    def forward(self, x):
        b1 = self.ConvBN_0(x)
        b7 = self.ConvBN_3(self.ConvBN_2(self.ConvBN_1(x)))
        bd = self.ConvBN_4(x)
        for conv in (self.ConvBN_5, self.ConvBN_6, self.ConvBN_7,
                     self.ConvBN_8):
            bd = conv(bd)
        bp = self.ConvBN_9(avg_pool(x))
        return torch.cat([b1, b7, bd, bp], dim=1)


class ReductionB(nn.Module):
    """17×17 → 8×8 (keras mixed8)."""

    def __init__(self, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = in_features
        _add_convs(self, dtype, [
            (c, 192, (1, 1)), (192, 320, (3, 3), _S2, "VALID"),
            (c, 192, (1, 1)), (192, 192, (1, 7)), (192, 192, (7, 1)),
            (192, 192, (3, 3), _S2, "VALID"),
        ])
        self.out_features = 320 + 192 + c

    def forward(self, x):
        b3 = self.ConvBN_1(self.ConvBN_0(x))
        b7 = self.ConvBN_2(x)
        for conv in (self.ConvBN_3, self.ConvBN_4, self.ConvBN_5):
            b7 = conv(b7)
        return torch.cat([b3, b7, max_pool(x)], dim=1)


class InceptionBlockC(nn.Module):
    """8×8 mixed block with split 1x3/3x1 branches."""

    def __init__(self, in_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = in_features
        _add_convs(self, dtype, [
            (c, 320, (1, 1)),
            (c, 384, (1, 1)), (384, 384, (1, 3)), (384, 384, (3, 1)),
            (c, 448, (1, 1)), (448, 384, (3, 3)), (384, 384, (1, 3)),
            (384, 384, (3, 1)),
            (c, 192, (1, 1)),
        ])
        self.out_features = 320 + 768 + 768 + 192

    def forward(self, x):
        b1 = self.ConvBN_0(x)
        b3 = self.ConvBN_1(x)
        b3 = torch.cat([self.ConvBN_2(b3), self.ConvBN_3(b3)], dim=1)
        bd = self.ConvBN_5(self.ConvBN_4(x))
        bd = torch.cat([self.ConvBN_6(bd), self.ConvBN_7(bd)], dim=1)
        bp = self.ConvBN_8(avg_pool(x))
        return torch.cat([b1, b3, bd, bp], dim=1)


class InceptionV3(nn.Module):
    """Input: float NCHW [N, 3, 299, 299] preprocessed to [-1, 1].

    ``forward(x, features_only=True)`` returns the 2048-d global-pool
    vector the featurizer emits (float32); otherwise the logits."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        _add_convs(self, dtype, [
            (3, 32, (3, 3), _S2, "VALID"),
            (32, 32, (3, 3), (1, 1), "VALID"),
            (32, 64, (3, 3)),
            (64, 80, (1, 1), (1, 1), "VALID"),
            (80, 192, (3, 3), (1, 1), "VALID"),
        ])
        plan = ([(InceptionBlockA, p) for p in (32, 64, 64)]
                + [(ReductionA, None)]
                + [(InceptionBlockB, c7) for c7 in (128, 160, 160, 192)]
                + [(ReductionB, None)]
                + [(InceptionBlockC, None)] * 2)
        self.block_names = []
        counts = {}
        c = 192
        for cls, arg in plan:
            block = cls(c, arg, dtype=dtype) if arg else cls(c, dtype=dtype)
            i = counts[cls] = counts.get(cls, -1) + 1
            name = f"{cls.__name__}_{i}"
            self.add_module(name, block)
            self.block_names.append(name)
            c = block.out_features
        self.fc = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor, features_only: bool = False):
        x = x.to(self.dtype)
        x = self.ConvBN_2(self.ConvBN_1(self.ConvBN_0(x)))
        x = max_pool(x)
        x = self.ConvBN_4(self.ConvBN_3(x))
        x = max_pool(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        feats = global_avg_pool(x).to(torch.float32)
        if features_only:
            return feats
        return self.fc(feats)
