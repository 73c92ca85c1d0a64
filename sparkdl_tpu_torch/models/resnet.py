"""ResNet50 in PyTorch — counterpart of ``sparkdl_tpu/models/resnet.py``
(224×224, caffe preprocessing; a 7×7/2 stem, a 3×3/2 max-pool, bottleneck
stages [3, 4, 6, 3]; ``features_only`` returns the 2048-d global pool).

keras.applications' ResNet50 has biased convs and BatchNorm epsilon
1.001e-5. Submodules carry flax's names: in a bottleneck that projects
its shortcut, the projection is created first, so it is ``ConvBN_0`` and
the main branch ``ConvBN_1..3``; otherwise the main branch is
``ConvBN_0..2``.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import (
    ConvBN as _ConvBN,
    global_avg_pool,
    max_pool,
)

ConvBN = functools.partial(_ConvBN, bn_epsilon=1.001e-5, use_bias=True)


class Bottleneck(nn.Module):
    def __init__(self, in_features: int, filters: int,
                 strides=(1, 1), project: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = filters * 4
        specs = [(in_features, filters, (1, 1), strides, True),
                 (filters, filters, (3, 3), (1, 1), True),
                 (filters, out, (1, 1), (1, 1), False)]
        if project:
            specs.insert(0, (in_features, out, (1, 1), strides, False))
        for i, (cin, cout, kernel, s, relu) in enumerate(specs):
            self.add_module(f"ConvBN_{i}", ConvBN(
                cin, cout, kernel, strides=s, relu=relu, dtype=dtype))
        self.project = project

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first = 1 if self.project else 0
        shortcut = self.ConvBN_0(x) if self.project else x
        y = x
        for i in range(first, first + 3):
            y = getattr(self, f"ConvBN_{i}")(y)
        return F.relu(y + shortcut)


class ResNet50(nn.Module):
    """Input: float NCHW [N, 3, 224, 224], caffe-preprocessed (BGR,
    mean-subtracted)."""

    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ConvBN_0 = ConvBN(3, 64, (7, 7), strides=(2, 2),
                               padding=[(3, 3), (3, 3)], dtype=dtype)
        self.block_names = []
        c = 64
        for i, (blocks, filters) in enumerate(
                zip([3, 4, 6, 3], [64, 128, 256, 512])):
            for b in range(blocks):
                strides = (2, 2) if (b == 0 and i > 0) else (1, 1)
                name = f"Bottleneck_{len(self.block_names)}"
                self.add_module(name, Bottleneck(
                    c, filters, strides, project=(b == 0), dtype=dtype))
                self.block_names.append(name)
                c = filters * 4
        self.fc = nn.Linear(c, num_classes)

    def forward(self, x: torch.Tensor, features_only: bool = False):
        x = self.ConvBN_0(x.to(self.dtype))
        x = max_pool(x, (3, 3), (2, 2), padding=[(1, 1), (1, 1)])
        for name in self.block_names:
            x = getattr(self, name)(x)
        feats = global_avg_pool(x).to(torch.float32)
        if features_only:
            return feats
        return self.fc(feats)
