"""Fused device-side image infeed: dequant + anti-aliased bilinear
resize + affine normalize, from RGB or from packed planar 4:2:0 YCbCr.

Counterpart of ``sparkdl_tpu/ops/infeed.py`` (``bilinear_weight_matrix``,
the RGB ``fused_resize_normalize`` and ``fused_yuv420_resize_normalize``;
the 4:2:0 op is further down)::

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

:func:`fused_resize_normalize` calls the registered op
``torch.ops.sparkdl_tpu_torch.resize_normalize`` on every device. The op's
CPU implementation is the plain version, its CUDA implementation the
kernel, which launches or raises, and its fake implementation gives the
output's shape and dtype from the input's (which may be symbolic) without
launching anything, so ``torch.export`` and ``FakeTensorMode`` trace
through it and an exported program holds the op by name. ``launches``
counts the kernel's launches, so a run can show that its main path went
through the kernel.
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

    Goes through the registered op ``sparkdl_tpu_torch::resize_normalize``:
    a CPU tensor to :func:`fused_resize_normalize_plain`, a CUDA tensor to
    the CUDA kernel on the current stream, one launch per call, with bands
    of up to ``ROWS`` output rows, and a fake tensor (``torch.export``,
    ``FakeTensorMode``) to the output's shape alone. The kernel raises on
    a non-contiguous input, a geometry the plan cannot tile, or a refused
    launch, and never falls back to the plain version."""
    h, w = _check_input(x, out_hw)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return torch.ops.sparkdl_tpu_torch.resize_normalize(
        x, h, w, float(scale), float(offset))


# K1 as a registered op: the geometry goes in as ints and the plan is
# built inside the real implementations
@torch.library.custom_op(
    "sparkdl_tpu_torch::resize_normalize", mutates_args=(),
    device_types="cpu",
    schema="(Tensor x, int h, int w, float scale, float offset) -> Tensor")
def _resize_normalize_op(x, h, w, scale, offset):
    # contiguous, as the kernel's output and the fake's are
    return fused_resize_normalize_plain(x, (h, w), scale,
                                        offset).contiguous()


@_resize_normalize_op.register_kernel("cuda")
def _resize_normalize_cuda(x, h, w, scale, offset):
    return _launch(x, h, w, scale, offset, ROWS)


@_resize_normalize_op.register_fake
def _resize_normalize_fake(x, h, w, scale, offset):
    return x.new_empty((x.shape[0], h, w, x.shape[3]), dtype=torch.float32)


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


def round_to_uint8(y: torch.Tensor) -> torch.Tensor:
    """Round half to even (``torch.round``, as ``jnp.round``), clip to
    [0, 255], cast to uint8 — what a host resize would have produced."""
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Packed planar YCbCr 4:2:0 → RGB, resized and normalized
#
# Counterpart of ``sparkdl_tpu/ops/infeed.py::fused_yuv420_resize_normalize``
# (an XLA einsum chain in the JAX package, not a Pallas kernel)::
#
#     uint8 [N, H*W*3/2]  →  float32 or uint8 [N, h, w, 3]
#
# Two implementations of the same function: the plain PyTorch version
# (per-plane einsums, then the colour math; the CPU path and the card's
# reference), and the CUDA kernel ``csrc/yuv420_resize_normalize.cu`` (K2):
# one launch per call, laid out by :func:`yuv420_plan`.
# ---------------------------------------------------------------------------

# BT.601 full-range inverse (the JPEG/JFIF matrix libjpeg's fixed-point
# tables implement): R = Y + 1.402·Cr′, G = Y − 0.344136·Cb′ −
# 0.714136·Cr′, B = Y + 1.772·Cb′, with Cb′/Cr′ zero-centered at 128.
_CR_R = 1.402
_CB_G = -0.114 * 1.772 / 0.587
_CR_G = -0.299 * 1.402 / 0.587
_CB_B = 1.772

KERNEL_YUV420 = "yuv420_resize_normalize"
# kernel launches made by fused_yuv420_resize_normalize (one per call on a
# CUDA tensor); reset and read by callers that prove the kernel ran
yuv420_launches = 0
# output rows per band, the only band height the kernel is built for (R in
# csrc/yuv420_resize_normalize.cu)
YUV420_ROWS = 8
# per block: three blocks share an SM's 228 KB (the kernel opts in past
# 48 KB)
YUV420_SMEM_BUDGET = 75 * 1024
# threads per block (kThreads in the kernel): a tile of up to this many
# output columns takes one column a thread in the column pass
YUV420_THREADS = 320
# source columns a thread takes in the row pass (kChunk in the kernel)
YUV420_CHUNK = 8


def _yuv420_src(x: torch.Tensor, src_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(H, W) after checking them against the packed rows of ``x``."""
    H, W = int(src_hw[0]), int(src_hw[1])
    if H <= 0 or W <= 0 or H % 2 or W % 2:
        # 0 is even — guard positivity too, or (0, 0) slips through to
        # empty planes
        raise ValueError(
            f"yuv420 needs positive even source dims, got {H}x{W}")
    expect = H * W + 2 * (H // 2) * (W // 2)
    if x.shape[1] != expect:
        raise ValueError(
            f"packed 4:2:0 row is {x.shape[1]} bytes, expected "
            f"{expect} for {H}x{W}")
    return H, W


def yuv420_unpack(x: torch.Tensor, src_hw: Tuple[int, int]):
    """Split a packed planar 4:2:0 batch [N, H*W*3/2] into
    (y [N,H,W,1], cb [N,H/2,W/2,1], cr [N,H/2,W/2,1]) views."""
    H, W = _yuv420_src(x, src_hw)
    n = x.shape[0]
    q = (H // 2) * (W // 2)
    y = x[:, :H * W].reshape(n, H, W, 1)
    cb = x[:, H * W:H * W + q].reshape(n, H // 2, W // 2, 1)
    cr = x[:, H * W + q:].reshape(n, H // 2, W // 2, 1)
    return y, cb, cr


def _check_yuv420(x: torch.Tensor, out_hw, out_dtype) -> Tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(
            f"expected packed 4:2:0 rows [N, H*W*3/2], got {tuple(x.shape)}")
    if x.dtype != torch.uint8:
        raise TypeError(f"packed 4:2:0 rows must be uint8, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.uint8):
        raise TypeError(f"out_dtype must be torch.float32 or torch.uint8, "
                        f"got {out_dtype}")
    h, w = int(out_hw[0]), int(out_hw[1])
    if h <= 0 or w <= 0:
        raise ValueError(f"output dims must be positive, got {(h, w)}")
    return h, w


def fused_yuv420_resize_normalize_plain(
        x: torch.Tensor, src_hw: Tuple[int, int], out_hw: Tuple[int, int],
        scale: float = 1.0, offset: float = 0.0,
        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed 4:2:0 uint8 ``[N, H*W*3/2]`` → ``[N, h, w, 3]`` RGB in fp32
    on ``x``'s device, by the JAX package's chain: each plane resized
    straight to (h, w) by :func:`fused_resize_normalize_plain` (so the
    chroma's 2× upsample and the resize are one matmul pair per axis),
    BT.601 inverse, clip to [0, 255], then ``*scale + offset``. A uint8
    ``out_dtype`` rounds that half to even and clips
    (:func:`round_to_uint8`)."""
    h, w = _check_yuv420(x, out_hw, out_dtype)
    planes = [fused_resize_normalize_plain(p, (h, w))[..., 0]
              for p in yuv420_unpack(x, src_hw)]
    yf, cbf, crf = planes[0], planes[1] - 128.0, planes[2] - 128.0
    rgb = torch.stack([yf + _CR_R * crf,
                       yf + _CB_G * cbf + _CR_G * crf,
                       yf + _CB_B * cbf], dim=-1)
    out = torch.clamp(rgb, 0.0, 255.0) * scale + offset
    return round_to_uint8(out) if out_dtype == torch.uint8 else out


class PlanePlan(NamedTuple):
    """K2's layout of one plane (luma, or both chroma planes)."""
    row_weights: np.ndarray  # [h, row_taps] fp32: output row y's weights
    #                          from source row row_lo[y], 0 past row_hi[y]
    row_lo: np.ndarray       # [h] int32 first source row of output row y
    row_hi: np.ndarray       # [h] int32 one past its last
    bands: np.ndarray        # [bands, 2] source rows [rs, re) of each band
    tiles: np.ndarray        # [tiles, 2] source columns [cs, ce) of each tile
    col_weights: np.ndarray  # [w, col_taps] fp32: column x's weights from
    #                          col_lo[x], zero-padded to an even col_taps
    col_lo: np.ndarray       # [w] int32 first source column of column x
    col_hi: np.ndarray       # [w] int32 one past its last
    depth: int               # ring slots: two bands' source rows
    pitch: int               # bytes of a ring slot (a multiple of 16): the
    #                          widest tile's row, up to 15 bytes after the
    #                          slot's start
    t_pitch: int             # floats of one row of the row pass's results:
    #                          every column a tile's padded taps read, in
    #                          whole chunks of YUV420_CHUNK


class Yuv420Plan(NamedTuple):
    tile_w: int         # output columns per tile
    luma: PlanePlan
    chroma: PlanePlan
    staged: bool        # a band's output goes through shared memory and
    #                     out in 16-byte stores (one tile only)
    smem: int           # dynamic shared memory of one block, bytes


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _yuv420_smem_bytes(tile_w: int, w: int, luma: PlanePlan,
                       chroma: PlanePlan, staged: bool,
                       out_itemsize: int) -> int:
    """As ``layout`` in csrc/yuv420_resize_normalize.cu: the rings of Y,
    Cb and Cr; the row pass's results (Y's, then Cb's and Cr's
    interleaved); the column buffers, a tile's column weights and first
    columns (Y's, then the chroma's; one buffer for a one-tile plan, else
    three, one per item number mod 3); two items' row taps (first rows,
    ends and
    weights of a band's output rows, Y's then the chroma's); both planes'
    bands and tiles and two items published for the loader; and, when
    staged, a band's uint8 output."""
    R = YUV420_ROWS
    ring = luma.depth * luma.pitch + 2 * chroma.depth * chroma.pitch
    t = 4 * R * (luma.t_pitch + 2 * chroma.t_pitch)
    cols = sum(4 * _round_up(tile_w, 4) * (p.col_weights.shape[1] + 1)
               for p in (luma, chroma))
    taps = 2 * sum(_round_up(4 * R * (2 + p.row_weights.shape[1]), 16)
                   for p in (luma, chroma))
    spans = _round_up(16 * (len(luma.bands) + len(luma.tiles)), 16) + 32
    stage = _round_up(15 + R * w * 3 * out_itemsize, 16) if staged else 0
    return (ring + t + cols * (1 if len(luma.tiles) == 1 else 3) + taps
            + spans + stage)


def yuv420_plan(src_h: int, src_w: int, h: int, w: int,
                out_itemsize: int = 1) -> Yuv420Plan:
    """K2's launch plan for one geometry (``out_itemsize`` 1 for uint8
    output, 4 for float32). A work item is a band of ``YUV420_ROWS``
    output rows by a tile of output columns of one image; persistent
    blocks walk runs of items, streaming each plane's source rows, cut to
    the tile's column span, through a ring of two bands' rows in shared
    memory. Per plane: the row taps of each output row, the column taps
    of each output column (zero-padded to an even count), and the source
    rows and columns of each band and tile. The plan picks the fewest
    tiles of at most ``YUV420_THREADS`` columns whose shared memory fits
    ``YUV420_SMEM_BUDGET`` (a larger source gets narrower tiles, not more
    shared memory), and stages the uint8 output of a one-tile plan when
    that fits too. Raises ValueError for
    odd or zero source dims, and for a downscale so steep that one output
    column does not fit."""
    if src_h <= 0 or src_w <= 0 or src_h % 2 or src_w % 2:
        raise ValueError(
            f"yuv420 needs positive even source dims, got {src_h}x{src_w}")
    R = YUV420_ROWS
    geometry = []
    for sh, sw in ((src_h, src_w), (src_h // 2, src_w // 2)):
        rows = band_weights(bilinear_weight_matrix(sh, h))
        cw, clo, chi = band_weights(bilinear_weight_matrix(sw, w))
        cw = np.pad(cw, ((0, 0), (0, cw.shape[1] % 2)))
        bands = _spans(rows[1], rows[2], R)
        geometry.append((rows, bands, (cw, clo, chi)))

    last_tile_w = 0
    for n_tiles in range(-(-w // YUV420_THREADS), w + 1):
        tile_w = -(-w // n_tiles)
        if n_tiles > 1:
            # tiles start at multiples of 4 columns (the kernel copies
            # column weights 16 bytes at a time)
            tile_w = _round_up(tile_w, 4)
        if tile_w == last_tile_w or (n_tiles > 1 and tile_w >= w):
            continue
        last_tile_w = tile_w
        planes = []
        for (rw, rlo, rhi), bands, (cw, clo, chi) in geometry:
            tiles = _spans(clo, chi, tile_w)
            span = int(np.ptp(tiles, axis=1).max())
            # every column a tile's padded taps read, past the tile's span
            # where its last columns' padding reaches
            reach = int((clo - tiles[np.arange(w) // tile_w, 0]).max()
                        + cw.shape[1])
            planes.append(PlanePlan(
                rw, rlo, rhi, bands, tiles, cw, clo, chi,
                2 * int(np.ptp(bands, axis=1).max()),
                _round_up(15 + span, 16),
                _round_up(max(span, reach), YUV420_CHUNK)))
        smem = _yuv420_smem_bytes(tile_w, w, *planes, False, out_itemsize)
        if smem > YUV420_SMEM_BUDGET:
            continue
        staged = _yuv420_smem_bytes(tile_w, w, *planes, True, out_itemsize)
        if (n_tiles == 1 and out_itemsize == 1
                and staged <= YUV420_SMEM_BUDGET):
            return Yuv420Plan(tile_w, *planes, True, staged)
        return Yuv420Plan(tile_w, *planes, False, smem)
    raise ValueError(
        f"yuv420 resize {src_h}x{src_w} -> {h}x{w} needs more than "
        f"{YUV420_SMEM_BUDGET} bytes of shared memory per block")

class _Plane(ctypes.Structure):
    # as struct Plane in csrc/yuv420_resize_normalize.cu
    _fields_ = [("row_w", ctypes.c_void_p), ("row_lo", ctypes.c_void_p),
                ("row_hi", ctypes.c_void_p), ("bands", ctypes.c_void_p),
                ("tiles", ctypes.c_void_p), ("col_w", ctypes.c_void_p),
                ("col_lo", ctypes.c_void_p), ("offset", ctypes.c_longlong),
                ("stride", ctypes.c_int), ("row_taps", ctypes.c_int),
                ("col_taps", ctypes.c_int), ("depth", ctypes.c_int),
                ("pitch", ctypes.c_int), ("t_pitch", ctypes.c_int)]


class _Yuv420Args(ctypes.Structure):
    # as struct Args in csrc/yuv420_resize_normalize.cu
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("queue", ctypes.c_void_p),
                ("luma", _Plane), ("chroma", _Plane),
                ("row_bytes", ctypes.c_longlong),
                ("cr_offset", ctypes.c_longlong),
                ("x_bytes", ctypes.c_longlong), ("items", ctypes.c_longlong),
                ("h", ctypes.c_int), ("w", ctypes.c_int),
                ("tile_w", ctypes.c_int), ("tiles", ctypes.c_int),
                ("bands", ctypes.c_int), ("staged", ctypes.c_int),
                ("affine", ctypes.c_int),
                ("scale", ctypes.c_float), ("offset", ctypes.c_float),
                ("cr_r", ctypes.c_float), ("cb_g", ctypes.c_float),
                ("cr_g", ctypes.c_float), ("cb_b", ctypes.c_float)]


def _yuv420_library():
    from sparkdl_tpu_torch.ops import _build
    lib = _build.load(KERNEL_YUV420)
    fn = lib.yuv420_resize_normalize_launch
    if not fn.argtypes:
        i, ip = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        args_p = ctypes.POINTER(_Yuv420Args)
        lib.yuv420_resize_normalize_args_size.argtypes = []
        lib.yuv420_resize_normalize_args_size.restype = i
        size = lib.yuv420_resize_normalize_args_size()
        if size != ctypes.sizeof(_Yuv420Args):
            raise RuntimeError(
                f"{KERNEL_YUV420}: the kernel's Args struct is {size} "
                f"bytes, its ctypes mirror {ctypes.sizeof(_Yuv420Args)}")
        lib.yuv420_resize_normalize_smem.argtypes = [args_p, i]
        lib.yuv420_resize_normalize_smem.restype = i
        lib.yuv420_resize_normalize_occupancy.argtypes = [i, i, ip, ip, ip]
        lib.yuv420_resize_normalize_occupancy.restype = i
        fn.argtypes = [args_p, i, i, i, ctypes.c_void_p]
        fn.restype = i
    return lib


def _yuv420_occupancy(lib, smem: int, out_u8: int,
                      device: torch.device) -> Tuple[int, int, int]:
    """(blocks per SM, registers, local bytes per thread) of K2's
    instance for ``out_u8`` with ``smem`` bytes, as the card reports
    them."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = lib.yuv420_resize_normalize_occupancy(
            out_u8, smem, *(ctypes.byref(v) for v in vals))
    if err != 0 or vals[0].value < 1:
        raise RuntimeError(f"{KERNEL_YUV420}: no block of {smem} bytes of "
                           f"shared memory fits an SM (CUDA error {err})")
    return vals[0].value, vals[1].value, vals[2].value


@functools.lru_cache(maxsize=8)
def _yuv420_device_plan(src_h: int, src_w: int, h: int, w: int,
                        out_itemsize: int, device: torch.device):
    """The plan, its arrays on ``device``, the launch arguments that do
    not change from call to call, and how many blocks the card holds at
    once (the persistent grid's size), built once per geometry and
    output type: per plane the row taps, bands, tiles, and the column
    weights transposed ([col_taps, w], so a warp's loads of them
    adjoin). The arrays are returned too: they must outlive the
    arguments that point at them."""
    plan = yuv420_plan(src_h, src_w, h, w, out_itemsize)
    arrays, planes = [], []
    offsets = (0, src_h * src_w)  # luma; Cb (Cr follows it)
    for p, stride, off in zip((plan.luma, plan.chroma),
                              (src_w, src_w // 2), offsets):
        # the column weights transposed and both column arrays padded to
        # a multiple of 4 columns, so the kernel copies them 16 bytes at
        # a time
        wp = _round_up(w, 4)
        col_w = np.zeros((p.col_weights.shape[1], wp), np.float32)
        col_w[:, :w] = p.col_weights.T
        col_lo = np.zeros(wp, np.int32)
        col_lo[:w] = p.col_lo
        a = [torch.as_tensor(np.ascontiguousarray(v), device=device)
             for v in (p.row_weights, p.row_lo, p.row_hi, p.bands, p.tiles,
                       col_w, col_lo)]
        arrays.append(a)
        planes.append(_Plane(*(v.data_ptr() for v in a), off, stride,
                             p.row_weights.shape[1], p.col_weights.shape[1],
                             p.depth, p.pitch, p.t_pitch))
    args = _Yuv420Args(
        None, None, None, *planes, src_h * src_w * 3 // 2,
        src_h * src_w + (src_h // 2) * (src_w // 2), 0, 0, h, w,
        plan.tile_w, len(plan.luma.tiles), len(plan.luma.bands),
        int(plan.staged), 0, 1.0, 0.0, _CR_R, _CB_G, _CR_G, _CB_B)
    lib = _yuv420_library()
    out_u8 = int(out_itemsize == 1)
    smem = lib.yuv420_resize_normalize_smem(ctypes.byref(args), out_u8)
    if smem != plan.smem:
        raise RuntimeError(f"plan reserves {plan.smem} bytes of shared "
                           f"memory, the kernel lays out {smem}")
    per_sm, _, _ = _yuv420_occupancy(lib, plan.smem, out_u8, device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return plan, arrays, args, per_sm * sms


def yuv420_launch_config(x: torch.Tensor, src_hw: Tuple[int, int],
                         out_hw: Tuple[int, int],
                         out_dtype: torch.dtype = torch.float32) -> dict:
    """How K2 launches for ``x`` (a CUDA tensor): the plan's bands, tiles,
    rings and staging, the persistent grid and the items each block
    walks, its shared memory as the kernel lays it out, and what the card
    reports (blocks per SM, registers, local memory per thread: 0 means no
    spills)."""
    h, w = _check_yuv420(x, out_hw, out_dtype)
    plan, _, args, slots = _yuv420_device_plan(
        *_yuv420_src(x, src_hw), h, w, out_dtype.itemsize, x.device)
    lib = _yuv420_library()
    u8 = int(out_dtype == torch.uint8)
    smem = lib.yuv420_resize_normalize_smem(ctypes.byref(args), u8)
    if smem != plan.smem:
        raise RuntimeError(f"plan reserves {plan.smem} bytes of shared "
                           f"memory, the kernel lays out {smem}")
    per_sm, regs, local = _yuv420_occupancy(lib, plan.smem, u8, x.device)
    tiles, bands = len(plan.luma.tiles), len(plan.luma.bands)
    items = x.shape[0] * tiles * bands
    grid = min(items, slots)
    return {"grid": [grid, 1, 1], "threads": YUV420_THREADS, "items": items,
            "items_per_block": items / grid,
            "smem_bytes": plan.smem, "rows": YUV420_ROWS,
            "tile_w": plan.tile_w, "tiles": tiles, "bands": bands,
            "ring_depth": [plan.luma.depth, plan.chroma.depth],
            "ring_pitch": [plan.luma.pitch, plan.chroma.pitch],
            "staged": plan.staged, "blocks_per_sm": per_sm,
            "registers": regs, "local_bytes": local}


def fused_yuv420_resize_normalize(
        x: torch.Tensor, src_hw: Tuple[int, int], out_hw: Tuple[int, int],
        scale: float = 1.0, offset: float = 0.0,
        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Packed planar YCbCr 4:2:0 uint8 ``[N, H*W*3/2]`` → ``[N, h, w, 3]``
    RGB: per-plane anti-aliased bilinear resize straight from each
    plane's own resolution, BT.601 inverse, clip to [0, 255], then
    ``y * scale + offset``; with ``out_dtype=torch.uint8`` that is rounded
    half to even and clipped, in the same pass.

    Goes through the registered op
    ``sparkdl_tpu_torch::yuv420_resize_normalize``: a CPU tensor to
    :func:`fused_yuv420_resize_normalize_plain`, a CUDA tensor to the CUDA
    kernel K2 on the current stream, one launch per call, and a fake
    tensor to the output's shape alone. The kernel raises on a
    non-contiguous input, a geometry the plan cannot lay out, or a refused
    launch, and never falls back to the plain version."""
    h, w = _check_yuv420(x, out_hw, out_dtype)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    H, W = _yuv420_src(x, src_hw)
    return torch.ops.sparkdl_tpu_torch.yuv420_resize_normalize(
        x, H, W, h, w, float(scale), float(offset), out_dtype)


# K2 as a registered op, as K1 above
@torch.library.custom_op(
    "sparkdl_tpu_torch::yuv420_resize_normalize", mutates_args=(),
    device_types="cpu",
    schema="(Tensor x, int H, int W, int h, int w, float scale, "
           "float offset, ScalarType out_dtype) -> Tensor")
def _yuv420_resize_normalize_op(x, H, W, h, w, scale, offset, out_dtype):
    return fused_yuv420_resize_normalize_plain(x, (H, W), (h, w), scale,
                                               offset, out_dtype).contiguous()


@_yuv420_resize_normalize_op.register_kernel("cuda")
def _yuv420_resize_normalize_cuda(x, H, W, h, w, scale, offset, out_dtype):
    return _launch_yuv420(x, H, W, h, w, scale, offset, out_dtype)


@_yuv420_resize_normalize_op.register_fake
def _yuv420_resize_normalize_fake(x, H, W, h, w, scale, offset, out_dtype):
    return x.new_empty((x.shape[0], h, w, 3), dtype=out_dtype)


_queues = {}


def _yuv420_queue(device: torch.device, stream: int) -> torch.Tensor:
    """The work queue K2's launches on ``stream`` share: two int32 0s,
    which each launch leaves at 0. Launches on one stream run one after
    another; each stream has its own, so concurrent launches do not share
    one. Made at a stream's first launch; under CUDA graph capture that
    is the capture stream's, so its zero-fill is captured too. (Two
    graphs captured on one stream share its queue: do not replay them at
    once.)"""
    key = (device, stream)
    queue = _queues.get(key)
    if queue is None:
        queue = _queues[key] = torch.zeros(2, dtype=torch.int32,
                                           device=device)
    return queue


def _launch_yuv420(x: torch.Tensor, H: int, W: int, h: int, w: int,
                   scale: float, offset: float,
                   out_dtype: torch.dtype) -> torch.Tensor:
    global yuv420_launches
    if not x.is_contiguous():
        raise ValueError("the CUDA 4:2:0 kernel needs a contiguous input")
    plan, _, template, slots = _yuv420_device_plan(
        H, W, h, w, out_dtype.itemsize, x.device)
    n = x.shape[0]
    out = torch.empty((n, h, w, 3), dtype=out_dtype, device=x.device)
    if n == 0:
        return out
    # the cached arguments, with this call's tensors, batch and affine
    args = _Yuv420Args.from_buffer_copy(template)
    args.x, args.out = x.data_ptr(), out.data_ptr()
    args.x_bytes = x.numel()
    args.items = n * template.tiles * template.bands
    args.scale, args.offset = scale, offset
    args.affine = int(scale != 1.0 or offset != 0.0)
    grid = min(args.items, slots)
    fn = _yuv420_library().yuv420_resize_normalize_launch
    u8 = int(out_dtype == torch.uint8)
    if x.device.index == torch.cuda.current_device():
        stream = torch.cuda.current_stream().cuda_stream
        args.queue = _yuv420_queue(x.device, stream).data_ptr()
        err = fn(ctypes.byref(args), u8, grid, plan.smem, stream)
    else:
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            args.queue = _yuv420_queue(x.device, stream).data_ptr()
            err = fn(ctypes.byref(args), u8, grid, plan.smem, stream)
    if err != 0:
        raise RuntimeError(
            f"{KERNEL_YUV420} kernel launch failed with CUDA error {err}")
    yuv420_launches += 1
    return out
