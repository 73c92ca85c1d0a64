"""Prebuilt converter pieces gluing the image schema to model tensors —
counterpart of ``sparkdl_tpu/graph/pieces.py`` (the reference's
``buildSpImageConverter`` and ``buildFlattener``). The runner already
packs image structs into contiguous uint8 NHWC batches, so the
converter's job on the device is the cast, scale and channel order: the
host ships uint8, a quarter of float32's bytes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sparkdl_tpu_torch._device import DeviceLike
from sparkdl_tpu_torch.graph.function import ModelFunction


class SpImageConvert(torch.nn.Module):
    """uint8 NHWC → float32 ``x * scale + offset``, channels reversed
    for BGR."""

    def __init__(self, bgr: bool, scale: float, offset: float):
        super().__init__()
        self.bgr = bgr
        self.scale = scale
        self.offset = offset

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        if self.bgr:
            x = torch.flip(x, [-1])
        if self.scale != 1.0:
            x = x * self.scale
        if self.offset != 0.0:
            x = x + self.offset
        return x


def buildSpImageConverter(height: int, width: int, nChannels: int = 3,
                          channel_order: str = "RGB", scale: float = 1.0,
                          offset: float = 0.0,
                          device: DeviceLike = None) -> ModelFunction:
    """uint8 [N, H, W, C] image batch → float32 ``x * scale + offset``,
    in BGR order if asked (the structs are RGB)."""
    if channel_order not in ("RGB", "BGR"):
        raise ValueError(f"channel_order must be RGB or BGR, "
                         f"got {channel_order!r}")
    return ModelFunction.fromSingle(
        SpImageConvert(channel_order == "BGR", scale, offset),
        input_shape=(height, width, nChannels), input_dtype=np.uint8,
        input_name="image", output_name="converted",
        name="spImageConverter", device=device)


class Flatten(torch.nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1).to(torch.float32)


def buildFlattener(input_shape: Tuple[int, ...] = (),
                   input_name: str = "input",
                   device: DeviceLike = None) -> ModelFunction:
    """[N, ...] → float32 [N, prod(...)] (reference ``buildFlattener``)."""
    return ModelFunction.fromSingle(
        Flatten(), input_shape=tuple(input_shape), input_name=input_name,
        output_name="flattened", name="flattener", device=device)
