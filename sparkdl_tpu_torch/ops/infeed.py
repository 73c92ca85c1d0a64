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
  kernel ``sparkdl_tpu/ops/infeed.py::_kernel``: one launch per call, both
  passes fused, laid out by :func:`resize_plan` (band weights, tiling and
  shared memory per geometry). Built with nvcc at first use
  (``ops/_build.py``) and bound with ctypes.

:func:`fused_resize_normalize` picks by the input's device: a CPU tensor
goes to the plain version, a CUDA tensor to the kernel, which launches
or raises. ``launches`` counts the kernel's launches, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

KERNEL = "resize_normalize"
THREADS = 256             # threads per block, as kThreads in the kernel

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


# Launch plan of the CUDA kernel. A work item is a band of ``rows`` output
# rows by a tile of ``tile_w`` output columns of one image. The kernel is
# persistent: each block walks a contiguous run of items (bands fastest),
# streaming their source rows, cut to the tile's column span, through one
# ring of ``depth`` rows of ``pitch`` bytes in shared memory; a band that
# continues the one before loads only the rows it adds, and the next
# item's rows are in flight while one is computed. Each item's row pass
# fills an fp32 tile ``t[rows, pitch / itemsize]`` there from the band's
# table of row weights (``band_table``), and its column pass writes the
# output from ``t``. ``_smem_bytes`` and ``smem_bytes`` in
# csrc/resize_normalize.cu lay shared memory out alike.
# output rows per band: the fastest at the main path's shape on an H100
# (chip_smoke.py's band-height sweep)
ROWS = 4
# the band heights the kernel is built for: those the plan picks (ROWS,
# or a shorter band for a steep vertical downscale), and 8, which only
# chip_smoke.py's band-height sweep launches
KERNEL_ROWS = (1, 2, 4, 8)
SMEM_BUDGET = 100 * 1024  # per block: at least two blocks on each SM
SMEM_MAX = 232448         # the most one block may have on Hopper (227 KB)


class ResizePlan(NamedTuple):
    h_weights: np.ndarray  # [h, h_taps] fp32: row y's weights from h_lo[y]
    h_lo: np.ndarray       # [h] int32 first source row of output row y
    h_hi: np.ndarray       # [h] int32 one past its last
    w_weights: np.ndarray  # [w, w_taps] fp32, the same per output column
    w_lo: np.ndarray
    w_hi: np.ndarray
    rows: int              # output rows per band
    tile_w: int            # output columns per tile
    bands: np.ndarray      # [bands, 2] source rows [rs, re) of each band
    band_table: np.ndarray  # [bands, span, rows] fp32: weight of source
    #                         row rs + i for output row band * rows + k
    tiles: np.ndarray      # [tiles, 2] source columns [cs, ce) of each tile
    depth: int             # source rows the ring holds
    pitch: int             # bytes of one ring slot (a multiple of 16)
    smem: int              # dynamic shared memory of one block, bytes


def band_weights(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """The nonzero band of each row of a [dst, src] weight matrix as
    ``(weights [dst, taps], lo, hi)``: ``weights[y, k] == w[y, lo[y] + k]``
    for ``k < hi[y] - lo[y]`` and 0 past it; ``taps`` is the widest band."""
    lo, hi = weight_bands(w)
    taps = int((hi - lo).max())
    idx = lo[:, None] + np.arange(taps)[None, :]
    inside = idx < hi[:, None]
    vals = np.take_along_axis(w, np.minimum(idx, w.shape[1] - 1), axis=1)
    return np.where(inside, vals, 0).astype(np.float32), lo, hi


def _spans(lo: np.ndarray, hi: np.ndarray, step: int) -> np.ndarray:
    """[blocks, 2] source span [lo[first], hi[last]) of each run of
    ``step`` outputs (lo and hi never decrease along the outputs)."""
    first = np.arange(0, len(lo), step)
    last = np.minimum(first + step, len(lo)) - 1
    return np.stack([lo[first], hi[last]], axis=1).astype(np.int32)


def _band_table(w: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                rows: int, bands: np.ndarray) -> np.ndarray:
    """The row weights as the kernel reads them: for each band, each of
    its source rows and each of its output rows, the weight (0 where the
    source row is not among that output row's taps, or past the image)."""
    span = int((bands[:, 1] - bands[:, 0]).max())
    table = np.zeros((len(bands), span, rows), np.float32)
    for y in range(len(lo)):
        b, k = divmod(y, rows)
        i = lo[y] - bands[b, 0]
        table[b, i:i + hi[y] - lo[y], k] = w[y, :hi[y] - lo[y]]
    return table


def _smem_bytes(rows: int, depth: int, pitch: int, itemsize: int) -> int:
    # the ring, then t
    return depth * pitch + rows * (pitch // itemsize) * 4


def resize_plan(src_h: int, h: int, src_w: int, w: int, c: int,
                smem_budget: int = SMEM_BUDGET, rows: int = ROWS,
                itemsize: int = 1) -> ResizePlan:
    """The CUDA kernel's launch plan for one geometry (``itemsize`` 1 for
    uint8 input, 4 for float32): band weights per axis, and the tiling
    that fits ``smem_budget``: the tallest band from ``rows`` down, then
    the fewest column tiles. The ring holds the item being computed and
    the one in flight after it, two band spans at most; a band's span
    follows the row taps and a tile's the column taps, so a larger source
    gets shorter bands or narrower tiles, not more shared memory. Raises
    ValueError for a downscale so steep that one output row and column do
    not fit."""
    if rows not in KERNEL_ROWS:
        raise ValueError(f"rows must be one of {KERNEL_ROWS}, got {rows}")
    hw_, h_lo, h_hi = band_weights(bilinear_weight_matrix(src_h, h))
    ww_, w_lo, w_hi = band_weights(bilinear_weight_matrix(src_w, w))
    # within the budget if it can be; else whatever one block may have
    for budget in sorted({min(smem_budget, SMEM_MAX), SMEM_MAX}):
        for r in KERNEL_ROWS[:KERNEL_ROWS.index(rows) + 1][::-1]:
            bands = _spans(h_lo, h_hi, r)
            depth = 2 * int((bands[:, 1] - bands[:, 0]).max())
            last_tile_w = 0
            for n_tiles in range(1, w + 1):
                tile_w = -(-w // n_tiles)
                if tile_w == last_tile_w:
                    continue
                last_tile_w = tile_w
                tiles = _spans(w_lo, w_hi, tile_w)
                span = int((tiles[:, 1] - tiles[:, 0]).max())
                # a slot keeps its row's 16-byte alignment: up to 15
                # bytes before the row
                pitch = -(-(15 + span * c * itemsize) // 16) * 16
                smem = _smem_bytes(r, depth, pitch, itemsize)
                if smem <= budget:
                    return ResizePlan(
                        hw_, h_lo, h_hi, ww_, w_lo, w_hi, r, tile_w, bands,
                        _band_table(hw_, h_lo, h_hi, r, bands), tiles,
                        depth, pitch, smem)
    raise ValueError(
        f"resize {src_h}x{src_w} -> {h}x{w} (C={c}) needs more than "
        f"{SMEM_MAX} bytes of shared memory per block")


def _library():
    from sparkdl_tpu_torch.ops import _build
    lib = _build.load(KERNEL)
    fn = lib.resize_normalize_launch
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, ctypes.c_longlong,
                       p, p, p, i, p, p, p, p,
                       i, i, i, i, i, i,
                       i, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
        lib.resize_normalize_smem.argtypes = [i] * 4
        lib.resize_normalize_smem.restype = ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.resize_normalize_occupancy.argtypes = [i, i, i, ip, ip, ip]
        lib.resize_normalize_occupancy.restype = ctypes.c_int
    return lib


def _occupancy(lib, plan: ResizePlan, x_is_u8: int,
               device: torch.device) -> Tuple[int, int, int]:
    """(blocks per SM, registers, local bytes per thread) of the kernel
    that runs ``plan``, as the card reports them."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.resize_normalize_occupancy(
            x_is_u8, plan.rows, plan.smem, *(ctypes.byref(v) for v in vals))
    if err != 0 or vals[0].value < 1:
        raise RuntimeError(f"{KERNEL}: no block of {plan.smem} bytes of "
                           f"shared memory fits an SM (CUDA error {err})")
    return vals[0].value, vals[1].value, vals[2].value


@functools.lru_cache(maxsize=8)
def _device_plan(src_h: int, h: int, src_w: int, w: int, c: int,
                 itemsize: int, rows: int, device: torch.device):
    """The plan, its band arrays on ``device`` and how many blocks the
    card holds at once (the persistent grid's size), built once per
    geometry (the main path calls with one geometry per run)."""
    plan = resize_plan(src_h, h, src_w, w, c, rows=rows, itemsize=itemsize)
    # the kernel reads the row weights per band, and the column weights
    # transposed, [w_taps, w], with zero taps up to a multiple of 4
    w_taps = -(-plan.w_weights.shape[1] // 4) * 4
    ww_t = np.zeros((w_taps, w), np.float32)
    ww_t[:plan.w_weights.shape[1]] = plan.w_weights.T
    arrays = tuple(torch.as_tensor(a, device=device) for a in (
        plan.band_table, plan.h_lo, plan.h_hi, ww_t, plan.w_lo, plan.w_hi))
    per_sm, _, _ = _occupancy(_library(), plan, int(itemsize == 1), device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan, arrays, per_sm * sms


def _grid(plan: ResizePlan, n: int, slots: int) -> int:
    return min(n * len(plan.tiles) * len(plan.bands), slots)


def launch_config(x: torch.Tensor, out_hw: Tuple[int, int],
                  rows: int = ROWS) -> dict:
    """How the kernel launches for ``x`` (a CUDA tensor) with bands of up
    to ``rows`` output rows: the plan's tiling, grid and threads, the
    shared memory the kernel's own layout needs, and what the card
    reports for it (blocks per SM, registers, local memory per thread)."""
    n, src_h, src_w, c = x.shape
    h, w = _check_input(x, out_hw)
    plan, _, slots = _device_plan(src_h, h, src_w, w, c, x.element_size(),
                                  rows, x.device)
    lib = _library()
    u8 = int(x.dtype == torch.uint8)
    smem = lib.resize_normalize_smem(u8, plan.rows, plan.depth, plan.pitch)
    if smem != plan.smem:
        raise RuntimeError(f"plan reserves {plan.smem} bytes of shared "
                           f"memory, the kernel lays out {smem}")
    per_sm, regs, local = _occupancy(lib, plan, u8, x.device)
    return {"grid": [_grid(plan, n, slots), 1, 1], "threads": THREADS,
            "items": n * len(plan.tiles) * len(plan.bands),
            "smem_bytes": plan.smem, "rows": plan.rows,
            "tile_w": plan.tile_w, "tiles": len(plan.tiles),
            "depth": plan.depth, "pitch": plan.pitch,
            "blocks_per_sm": per_sm, "registers": regs,
            "local_bytes": local}


def fused_resize_normalize(x: torch.Tensor, out_hw: Tuple[int, int],
                           scale: float = 1.0,
                           offset: float = 0.0) -> torch.Tensor:
    """uint8/float32 [N, H, W, C] → float32 [N, h, w, C]: anti-aliased
    bilinear resize then ``y * scale + offset``.

    A CPU tensor goes to :func:`fused_resize_normalize_plain`. A CUDA
    tensor goes to the CUDA kernel on the current stream, one launch per
    call, with bands of up to ``ROWS`` output rows; the wrapper raises on
    a non-contiguous input, a geometry the plan cannot tile, or a refused
    launch, and never falls back to the plain version."""
    h, w = _check_input(x, out_hw)
    if x.device.type == "cpu":
        return fused_resize_normalize_plain(x, (h, w), scale, offset)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, h, w, scale, offset, ROWS)


def _launch(x: torch.Tensor, h: int, w: int, scale: float, offset: float,
            rows: int) -> torch.Tensor:
    """One launch of the kernel on a CUDA tensor, with bands of up to
    ``rows`` output rows (:func:`fused_resize_normalize` passes ``ROWS``;
    chip_smoke.py's band-height sweep the others)."""
    global launches
    if not x.is_contiguous():
        raise ValueError("the CUDA resize kernel needs a contiguous input")
    n, src_h, src_w, c = x.shape
    # built first: raises for a zero source dim, as the plain version does
    plan, (bw, h_lo, h_hi, ww_, w_lo, w_hi), slots = _device_plan(
        src_h, h, src_w, w, c, x.element_size(), rows, x.device)
    out = torch.empty((n, h, w, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    fn = _library().resize_normalize_launch
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), int(x.dtype == torch.uint8),
                 x.numel() * x.element_size(),
                 bw.data_ptr(), h_lo.data_ptr(), h_hi.data_ptr(),
                 bw.shape[1], ww_.data_ptr(), w_lo.data_ptr(),
                 w_hi.data_ptr(), out.data_ptr(),
                 n, src_h, src_w, c, h, w,
                 plan.rows, plan.tile_w, plan.depth, plan.pitch,
                 plan.smem, _grid(plan, n, slots), float(scale),
                 float(offset), stream)
    if err != 0:
        raise RuntimeError(
            f"{KERNEL} kernel launch failed with CUDA error {err}")
    launches += 1
    return out
