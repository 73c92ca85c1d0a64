"""Synthetic textured images — counterpart of
``sparkdl_tpu/utils/synth.py::textured_image``, for runs that need
photo-like pixels without image files (``chip_smoke.py``) — and the
seeded partition source and 4:2:0 pack stage that make such a frame's
host work run where its partitions load (picklable, so a host-pipeline
worker or a decode server draws and packs the pixels itself)."""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class SeededImages:
    """A partition's ``Source.load`` that draws its images where it runs
    (a host-pipeline worker, a decode server) from ``(seed, partition)``,
    so the same partition gives the same pixels in any process. With
    ``textured`` the images are :func:`textured_image` ones in an
    ``[n, height, width, 3]`` uint8 column ``rgb``; without, uniform
    random pixels as image structs in an ``image`` column, ``origin``
    ``img_<row>`` numbered across partitions."""
    seed: int
    partition: int
    n: int
    height: int
    width: int
    textured: bool = True

    def __call__(self):
        rng = np.random.default_rng([self.seed, self.partition])
        if self.textured:
            return {"rgb": np.stack([
                textured_image(rng, self.height, self.width)
                for _ in range(self.n)])}
        from sparkdl_tpu_torch.data.frame import to_column
        from sparkdl_tpu_torch.image.imageIO import imageArrayToStruct
        imgs = rng.integers(0, 256, (self.n, self.height, self.width, 3),
                            dtype=np.uint8)
        first = self.partition * self.n
        return {"image": to_column([
            imageArrayToStruct(img, origin=f"img_{first + i:05d}")
            for i, img in enumerate(imgs)])}


@dataclasses.dataclass(frozen=True)
class PackYuv420:
    """A host stage: the RGB tensor column ``src`` → packed planar 4:2:0
    rows (``imageIO.rgbToYuv420``) in column ``dst``, in place of
    ``src``."""
    src: str = "rgb"
    dst: str = "image"

    def __call__(self, batch):
        from sparkdl_tpu_torch.image.imageIO import rgbToYuv420
        rgb = batch[self.src]
        packed = (np.stack([rgbToYuv420(img) for img in rgb]) if len(rgb)
                  else np.zeros((0, rgb.shape[1] * rgb.shape[2] * 3 // 2),
                                np.uint8))
        out = {k: v for k, v in batch.items() if k != self.src}
        out[self.dst] = packed
        return out
