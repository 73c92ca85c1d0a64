"""Xception in PyTorch — counterpart of ``sparkdl_tpu/models/xception.py``
(299×299, inception preprocessing; entry flow → 8 middle blocks → exit
flow; ``features_only`` returns the 2048-d global pool).

Submodules carry flax's names (``_EntryBlock_<i>``, ``_MiddleBlock_<i>``,
``SeparableConvBN_<i>``), so the weight bridge is a rename. The
depthwise convs go to ``F.conv2d(groups=C)`` (cuDNN on the card), as the
JAX package left them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    ConvBN,
    SeparableConvBN,
    global_avg_pool,
    max_pool,
)

_POOL_PADS = [(1, 1), (1, 1)]


class _EntryBlock(nn.Module):
    def __init__(self, in_features: int, features: int,
                 first_relu: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.first_relu = first_relu
        self.ConvBN_0 = ConvBN(in_features, features, (1, 1),
                               strides=(2, 2), relu=False, dtype=dtype)
        self.SeparableConvBN_0 = SeparableConvBN(in_features, features,
                                                 relu=False, dtype=dtype)
        self.SeparableConvBN_1 = SeparableConvBN(features, features,
                                                 relu=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.ConvBN_0(x)
        y = F.relu(x) if self.first_relu else x
        y = self.SeparableConvBN_0(y)
        y = self.SeparableConvBN_1(F.relu(y))
        return max_pool(y, (3, 3), (2, 2), padding=_POOL_PADS) + shortcut


class _MiddleBlock(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        for i in range(3):
            self.add_module(f"SeparableConvBN_{i}", SeparableConvBN(
                728, 728, relu=False, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(3):
            y = getattr(self, f"SeparableConvBN_{i}")(F.relu(y))
        return y + x


class Xception(nn.Module):
    """Input: float NCHW [N, 3, 299, 299] preprocessed to [-1, 1] (71×71
    at the least)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        # entry flow
        self.ConvBN_0 = ConvBN(3, 32, (3, 3), strides=(2, 2),
                               padding="VALID", dtype=dtype)
        self.ConvBN_1 = ConvBN(32, 64, (3, 3), padding="VALID", dtype=dtype)
        c = 64
        for i, (features, first_relu) in enumerate(
                [(128, False), (256, True), (728, True)]):
            self.add_module(f"_EntryBlock_{i}", _EntryBlock(
                c, features, first_relu, dtype=dtype))
            c = features
        # middle flow
        for i in range(8):
            self.add_module(f"_MiddleBlock_{i}", _MiddleBlock(dtype=dtype))
        # exit flow
        self.ConvBN_2 = ConvBN(728, 1024, (1, 1), strides=(2, 2),
                               relu=False, dtype=dtype)
        for i, (cin, cout, relu) in enumerate(
                [(728, 728, False), (728, 1024, False),
                 (1024, 1536, True), (1536, 2048, True)]):
            self.add_module(f"SeparableConvBN_{i}", SeparableConvBN(
                cin, cout, relu=relu, dtype=dtype))
        self.fc = nn.Linear(2048, num_classes)

    def forward(self, x: torch.Tensor, features_only: bool = False):
        x = self.ConvBN_1(self.ConvBN_0(x.to(self.dtype)))
        for i in range(3):
            x = getattr(self, f"_EntryBlock_{i}")(x)
        for i in range(8):
            x = getattr(self, f"_MiddleBlock_{i}")(x)
        shortcut = self.ConvBN_2(x)
        y = self.SeparableConvBN_0(F.relu(x))
        y = self.SeparableConvBN_1(F.relu(y))
        x = max_pool(y, (3, 3), (2, 2), padding=_POOL_PADS) + shortcut
        x = self.SeparableConvBN_3(self.SeparableConvBN_2(x))
        feats = global_avg_pool(x).to(torch.float32)
        if features_only:
            return feats
        return self.fc(feats)
