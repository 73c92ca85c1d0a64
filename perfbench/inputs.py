"""The benchmark's inputs, made on the run's device from the seed in a
few large calls and handed to the program and the reference alike.

``textured`` is a batched form of the program's
``utils/synth.py::textured_image`` (photo-like pixels: per channel three
octaves of low-frequency sinusoids, plus pixel noise), about a mean
colour of its own for each image (each channel uniform in 64-192, where
``textured_image`` centres every image on 128): with the seeded weights,
images of one grey level give features so alike that a row handed back
in another row's place could pass; ``pack_yuv420``
is ``image/imageIO.py::rgbToYuv420`` on the device (BT.601 full range,
2x2 box-averaged chroma, planes Y, Cb, Cr).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# image blocks per call: bounds the float32 temporaries at 512 x 512
BLOCK = 64


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a seed;
    seeds beyond 64 bits wrap."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + stream) % (1 << 63))


def _textured_block(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((n, 3, 3), generator=gen,
                                           device=device)
    fx, fy = u(1.0, 6.0) * math.pi / w, u(1.0, 6.0) * math.pi / h
    amp, px, py = u(20.0, 60.0), u(0.0, 2 * math.pi), u(0.0, 2 * math.pi)
    base = 64.0 + 128.0 * torch.rand((n, 1, 1, 3), generator=gen,
                                     device=device)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    yy = torch.arange(h, device=device, dtype=torch.float32)
    sx = torch.sin(fx[..., None] * xx + px[..., None]) * amp[..., None]
    cy = torch.cos(fy[..., None] * yy + py[..., None])
    img = torch.einsum("ncox,ncoy->nyxc", sx, cy) + base
    img += 6.0 * torch.randn(img.shape, generator=gen, device=device)
    return torch.clamp(img, 0, 255).to(torch.uint8)


def textured(seed: int, n: int, hw, device) -> torch.Tensor:
    """uint8 RGB [n, h, w, 3] on ``device``."""
    gen = generator(seed, 1, device)
    h, w = hw
    return torch.cat([_textured_block(gen, min(BLOCK, n - i), h, w, device)
                      for i in range(0, n, BLOCK)])


def pack_yuv420(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 RGB [n, h, w, 3] -> packed planar 4:2:0 rows
    [n, h*w*3/2]."""
    n, h, w, _ = rgb.shape
    f = rgb.to(torch.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b

    def half(p):
        return p.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def q(p):
        return torch.clamp(torch.floor(p + 0.5), 0, 255).to(
            torch.uint8).reshape(n, -1)

    return torch.cat([q(y), q(half(cb)), q(half(cr))], dim=1)


def rows(seed: int, n: int, fmt: str, hw, device) -> np.ndarray:
    """The mix's rows on the host: packed 4:2:0 ``[n, h*w*3/2]`` for
    ``"yuv420"``, else RGB pixels ``[n, h, w, 3]``."""
    out = []
    for i in range(0, n, BLOCK * 4):
        rgb = textured(seed + i, min(BLOCK * 4, n - i), hw, device)
        out.append((pack_yuv420(rgb) if fmt == "yuv420" else rgb).cpu())
    return torch.cat(out).numpy()
