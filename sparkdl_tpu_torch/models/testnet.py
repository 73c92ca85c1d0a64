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


def synthetic_testnet_dataset(n: int, seed: int = 0,
                              noise: float = 40.0,
                              proto_seed: int = 1234):
    """The port's copy of the JAX package's dataset of the committed
    TestNet: 10 classes, each a fixed random 32×32×3 prototype (from
    ``proto_seed``), samples the prototype plus Gaussian pixel noise
    (from ``seed``). Returns ``(images uint8 [n, 32, 32, 3], labels
    int32 [n])``; the artifact's provenance records the parameters of
    its held-out split."""
    import numpy as np
    protos = np.random.default_rng(proto_seed).integers(
        0, 255, size=(10, 32, 32, 3)).astype(np.float32)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    imgs = protos[labels] + rng.normal(0.0, noise, size=(n, 32, 32, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8), labels
