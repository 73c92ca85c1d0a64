"""Fused device-side image infeed: dequant + anti-aliased bilinear
resize + affine normalize.

Counterpart of ``sparkdl_tpu/ops/infeed.py`` (``bilinear_weight_matrix``
and the RGB ``fused_resize_normalize``)::

    uint8 or float32 [N, H, W, C]  →  float32 [N, h, w, C]
    out = resize_bilinear(x) * scale + offset

Resampling is separable: ``t = Wh @ x`` over rows, then ``out = Ww @ t``
over columns, with the triangle weights of :func:`bilinear_weight_matrix`
(the kernel ``jax.image.resize(method="bilinear")`` applies).

Two implementations of the same function:

* :func:`fused_resize_normalize_plain` — two fp32 einsums in PyTorch. The
  CPU path, and the reference the CUDA kernel is held to on the card.
* the CUDA kernel ``csrc/resize_normalize.cu`` — replaces the Pallas TPU
  kernel ``sparkdl_tpu/ops/infeed.py::_kernel``. Built with nvcc at first
  use (``ops/_build.py``) and bound with ctypes.

:func:`fused_resize_normalize` picks by the input's device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel, which launches
or raises. ``launches`` counts the kernel's launches, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

KERNEL = "resize_normalize"

# kernel launches made by fused_resize_normalize (one per call on a CUDA
# tensor); reset and read by callers that prove the kernel ran
launches = 0


def bilinear_weight_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] anti-aliased bilinear (triangle) interpolation weights,
    half-pixel convention — the same kernel ``jax.image.resize`` applies
    (support widens by 1/scale when downsampling, so downscales average
    instead of skipping rows)."""
    if src <= 0 or dst <= 0:
        # a zero dim degenerates to empty matmuls and empty outputs
        # downstream instead of an attributable error here
        raise ValueError(
            f"resize dims must be positive, got {src} -> {dst}")
    if src == dst:
        return np.eye(dst, dtype=np.float32)
    scale = dst / src
    # output pixel y's center in source coordinates
    centers = (np.arange(dst, dtype=np.float64) + 0.5) / scale - 0.5
    # triangle kernel, widened for anti-aliasing when downsampling
    inv_support = min(scale, 1.0)
    dist = np.abs(centers[:, None] - np.arange(src)[None, :])
    w = np.maximum(0.0, 1.0 - dist * inv_support)
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def weight_bands(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per output row of a [dst, src] weight matrix, the half-open range
    ``[lo, hi)`` of its nonzero source columns. Outside it every weight
    is exactly 0, so the kernel skips those multiply-adds."""
    nz = w != 0
    lo = nz.argmax(axis=1)
    hi = w.shape[1] - nz[:, ::-1].argmax(axis=1)
    return lo.astype(np.int32), hi.astype(np.int32)


def _check_input(x: torch.Tensor, out_hw) -> Tuple[int, int]:
    if x.dim() != 4:
        raise ValueError(f"expected [N, H, W, C] input, got {tuple(x.shape)}")
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"input must be uint8 or float32, got {x.dtype}")
    h, w = int(out_hw[0]), int(out_hw[1])
    if h <= 0 or w <= 0:
        raise ValueError(f"output dims must be positive, got {(h, w)}")
    return h, w


def fused_resize_normalize_plain(x: torch.Tensor, out_hw: Tuple[int, int],
                                 scale: float = 1.0,
                                 offset: float = 0.0) -> torch.Tensor:
    """uint8/float32 [N, H, W, C] → float32 [N, h, w, C] by two fp32
    einsums on ``x``'s device — the same chain as the JAX package's XLA
    path (``_resize_math``). Exact fp32 on the card only while
    ``torch.backends.cuda.matmul.allow_tf32`` is False (its default)."""
    h, w = _check_input(x, out_hw)
    _, src_h, src_w, _ = x.shape
    wh = torch.as_tensor(bilinear_weight_matrix(src_h, h), device=x.device)
    ww = torch.as_tensor(bilinear_weight_matrix(src_w, w), device=x.device)
    t = torch.einsum("yv,nvuc->nyuc", wh, x.to(torch.float32))
    out = torch.einsum("xu,nyuc->nyxc", ww, t)
    return out * scale + offset


@functools.lru_cache(maxsize=8)
def _device_weights(src_h: int, h: int, src_w: int, w: int,
                    device: torch.device):
    """Weight matrices and their bands on ``device``, built once per
    resize geometry (the main path calls with one geometry per run)."""
    out = []
    for src, dst in ((src_h, h), (src_w, w)):
        mat = bilinear_weight_matrix(src, dst)
        lo, hi = weight_bands(mat)
        out += [torch.as_tensor(a, device=device) for a in (mat, lo, hi)]
    return tuple(out)


def _launcher():
    from sparkdl_tpu_torch.ops import _build
    lib = _build.load(KERNEL)
    fn = lib.resize_normalize_launch
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p,
                       i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def fused_resize_normalize(x: torch.Tensor, out_hw: Tuple[int, int],
                           scale: float = 1.0,
                           offset: float = 0.0) -> torch.Tensor:
    """uint8/float32 [N, H, W, C] → float32 [N, h, w, C]: anti-aliased
    bilinear resize then ``y * scale + offset``.

    A CPU tensor goes to :func:`fused_resize_normalize_plain`. A CUDA
    tensor goes to the CUDA kernel on the current stream; the wrapper
    raises on a non-contiguous input or a refused launch, and never
    falls back to the plain version."""
    global launches
    h, w = _check_input(x, out_hw)
    if x.device.type == "cpu":
        return fused_resize_normalize_plain(x, (h, w), scale, offset)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the CUDA resize kernel needs a contiguous input")
    n, src_h, src_w, c = x.shape
    # built first: raises for a zero source dim, as the plain version does
    wh, h_lo, h_hi, ww, w_lo, w_hi = _device_weights(
        src_h, h, src_w, w, x.device)
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    # fp32 row-pass scratch [N, h, W, C], read back by the column pass
    tmp = torch.empty((n, h, src_w, c), dtype=torch.float32,
                      device=x.device)
    fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.uint8),
                 wh.data_ptr(), h_lo.data_ptr(), h_hi.data_ptr(),
                 ww.data_ptr(), w_lo.data_ptr(), w_hi.data_ptr(),
                 tmp.data_ptr(), out.data_ptr(),
                 n, src_h, src_w, c, h, w, float(scale), float(offset),
                 stream)
    if err != 0:
        raise RuntimeError(
            f"{KERNEL} kernel launch failed with CUDA error {err}")
    launches += 1
    return out
