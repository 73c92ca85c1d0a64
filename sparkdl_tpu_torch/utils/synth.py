"""Synthetic textured images — counterpart of
``sparkdl_tpu/utils/synth.py::textured_image``, for runs that need
photo-like pixels without image files (``chip_smoke.py``)."""

from __future__ import annotations

import numpy as np


def textured_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """One photo-like uint8 RGB image: per-channel sums of low-frequency
    sinusoids (smooth structure JPEG compresses like real content) plus
    low-amplitude pixel noise (so detail blocks aren't empty)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    chans = []
    for _ in range(3):
        img = np.zeros((h, w), np.float32)
        for _ in range(3):  # a few octaves of smooth structure
            fx = rng.uniform(1.0, 6.0) * np.pi / w
            fy = rng.uniform(1.0, 6.0) * np.pi / h
            amp = rng.uniform(20.0, 60.0)
            img += amp * np.sin(fx * xx + rng.uniform(0, 2 * np.pi)) \
                * np.cos(fy * yy + rng.uniform(0, 2 * np.pi))
        chans.append(img)
    arr = np.stack(chans, axis=-1) + 128.0
    arr += rng.normal(0.0, 6.0, size=arr.shape)  # mild sensor-like noise
    return np.clip(arr, 0, 255).astype(np.uint8)
