"""TestNet: the tiny test model — counterpart of
``sparkdl_tpu/models/testnet.py`` (3-layer CNN, 16-d features)."""

from __future__ import annotations

import torch
from torch import nn

from sparkdl_tpu_torch.models.layers import ConvBN, global_avg_pool, max_pool


class TestNet(nn.Module):
    """Input: float NCHW [N, 3, 32, 32] in [0, 1]. Submodules carry the
    flax module names (``models/convert.py``)."""

    __test__ = False  # a model, not a pytest test class

    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ConvBN_0 = ConvBN(3, 8, (3, 3), strides=(2, 2), dtype=dtype)
        self.ConvBN_1 = ConvBN(8, 16, (3, 3), dtype=dtype)
        self.fc = nn.Linear(16, num_classes)

    def forward(self, x: torch.Tensor, features_only: bool = False):
        x = self.ConvBN_0(x.to(self.dtype))
        x = max_pool(x, (2, 2), (2, 2), padding="SAME")
        x = self.ConvBN_1(x)
        feats = global_avg_pool(x).to(torch.float32)
        if features_only:
            return feats
        return self.fc(feats)
