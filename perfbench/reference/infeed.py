"""The plain reference of the device infeed: the anti-aliased bilinear
resize of RGB rows, the packed planar 4:2:0 -> RGB resize, and the
half-to-even round to the model's uint8 input.

Plain PyTorch in float32, written from the definitions (the triangle
filter of ``jax.image.resize(method="bilinear")``, widened by 1/scale
when downsampling, half-pixel centres; BT.601 full-range YCbCr as JPEG
stores it). It imports nothing of the program. Each function runs on the
device of its input, in blocks chosen by the caller.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

# BT.601 full-range inverse: R = Y + 1.402 Cr', G = Y - 0.344136 Cb' -
# 0.714136 Cr', B = Y + 1.772 Cb', with Cb', Cr' centred at 128
CR_R = 1.402
CB_G = -0.114 * 1.772 / 0.587
CR_G = -0.299 * 1.402 / 0.587
CB_B = 1.772


def triangle_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] resize weights: output pixel y takes source pixel v
    with weight max(0, 1 - |c(y) - v| * min(dst/src, 1)), c(y) its
    centre in source coordinates, each row normalised to sum 1."""
    if src == dst:
        return np.eye(dst, dtype=np.float32)
    scale = dst / src
    centres = (np.arange(dst, dtype=np.float64) + 0.5) / scale - 0.5
    dist = np.abs(centres[:, None] - np.arange(src)[None, :])
    w = np.maximum(0.0, 1.0 - dist * min(scale, 1.0))
    w /= w.sum(axis=1, keepdims=True)
    return w.astype(np.float32)


def resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 or float [N, H, W, C] -> float32 [N, h, w, C]."""
    _, src_h, src_w, _ = x.shape
    wh = torch.from_numpy(triangle_weights(src_h, out_hw[0])).to(x.device)
    ww = torch.from_numpy(triangle_weights(src_w, out_hw[1])).to(x.device)
    t = torch.einsum("yv,nvuc->nyuc", wh, x.to(torch.float32))
    return torch.einsum("xu,nyuc->nyxc", ww, t)


def round_uint8(y: torch.Tensor) -> torch.Tensor:
    """Half to even, clipped to [0, 255], as uint8."""
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def yuv420_to_rgb(x: torch.Tensor, src_hw: Tuple[int, int],
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Packed planar 4:2:0 rows uint8 [N, H*W*3/2] (Y, then Cb, then Cr
    at half size) -> float32 RGB [N, h, w, 3] in [0, 255]: each plane
    resized straight to (h, w) from its own size, then BT.601."""
    n = x.shape[0]
    H, W = src_hw
    q = (H // 2) * (W // 2)
    y = x[:, :H * W].reshape(n, H, W, 1)
    cb = x[:, H * W:H * W + q].reshape(n, H // 2, W // 2, 1)
    cr = x[:, H * W + q:].reshape(n, H // 2, W // 2, 1)
    yf = resize(y, out_hw)[..., 0]
    cbf = resize(cb, out_hw)[..., 0] - 128.0
    crf = resize(cr, out_hw)[..., 0] - 128.0
    rgb = torch.stack([yf + CR_R * crf, yf + CB_G * cbf + CR_G * crf,
                       yf + CB_B * cbf], dim=-1)
    return torch.clamp(rgb, 0.0, 255.0)


def model_input(x: torch.Tensor, src: dict,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """The model's uint8 input [N, h, w, 3] from the rows the program
    was given: ``src["format"]`` is ``"yuv420"`` (packed rows)
    or ``"rgb"`` (pixels [N, H, W, 3])."""
    hw = tuple(src["hw"])
    if src["format"] == "yuv420":
        return round_uint8(yuv420_to_rgb(x, hw, out_hw))
    if hw == tuple(out_hw):
        return x
    return round_uint8(resize(x, out_hw))
