"""VGG16 / VGG19 in PyTorch — counterpart of ``sparkdl_tpu/models/vgg.py``
(224×224, caffe preprocessing; ``features_only`` returns fc2, the
4096-d penultimate layer).

The convs carry biases and no BatchNorm; they and the two 4096-wide
Dense layers run in the model dtype, the bias added to its result, as
flax's ``nn.Conv``/``nn.Dense(dtype=...)`` do; the head runs in float32.
The submodules keep flax's names (``Conv_0…``, ``Dense_0…Dense_2``).
flax flattens the last feature map in NHWC order, so the port permutes
its NCHW map to NHWC before flattening and ``Dense_0``'s rows stay as
they are (a channels_last map permutes without a copy).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sparkdl_tpu_torch.models.layers import conv2d, max_pool

_FILTERS = (64, 128, 256, 512, 512)


class _VGG(nn.Module):
    blocks: Sequence[int] = ()

    def __init__(self, num_classes: int = 1000,
                 input_size: Tuple[int, int] = (224, 224),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv_names = []
        c = 3
        for n_convs, f in zip(self.blocks, _FILTERS):
            for _ in range(n_convs):
                name = f"Conv_{len(self.conv_names)}"
                self.add_module(name, nn.Conv2d(c, f, (3, 3)))
                self.conv_names.append(name)
                c = f
        h, w = (s // 2 ** len(self.blocks) for s in input_size)
        self.Dense_0 = nn.Linear(c * h * w, 4096)
        self.Dense_1 = nn.Linear(4096, 4096)
        self.Dense_2 = nn.Linear(4096, num_classes)

    def _dense(self, x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), layer.weight.to(self.dtype))
        return F.relu(y + layer.bias.to(self.dtype))

    def forward(self, x: torch.Tensor, features_only: bool = False):
        x = x.to(self.dtype)
        i = 0
        for n_convs in self.blocks:
            for _ in range(n_convs):
                conv = getattr(self, self.conv_names[i])
                x = F.relu(conv2d(x, conv, "SAME", self.dtype))
                i += 1
            x = max_pool(x, (2, 2), (2, 2))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = self._dense(self._dense(x, self.Dense_0), self.Dense_1)
        feats = x.to(torch.float32)   # fc2, the featurize layer
        if features_only:
            return feats
        return self.Dense_2(feats)


class VGG16(_VGG):
    blocks = (2, 2, 3, 3, 3)


class VGG19(_VGG):
    blocks = (2, 2, 4, 4, 4)
