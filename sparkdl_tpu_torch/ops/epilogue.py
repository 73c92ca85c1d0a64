"""The inference epilogue of a conv unit (K3): the conv's bias, BatchNorm
with its running statistics, a residual and ReLU, applied to the bf16
conv output in one pass::

    y         bf16 [N, C, H, W], channels_last or contiguous
    bias      bf16 [C] or None (the conv's)
    mean, mul, beta
              fp32 [C]; mul = rsqrt(running_var + eps) * weight
    residual  bf16, y's shape and layout, or None
    out       bf16 in y's layout:
              v = float(y) (+ bias, rounded to bf16)
              t = bf16(((v - mean) * mul) + beta) (+ residual, rounded)
              out = relu(t) if relu else t

Two implementations of the same function:

* :func:`conv_epilogue_plain` — the chain of eager PyTorch ops a conv unit
  of ``models/layers.py`` runs (the bf16 bias add, BatchNorm's fp32
  formula, the cast back, the residual add, ``F.relu``), a pass over the
  activation each. The CPU path, and the reference the kernel is held to
  on the card, which it equals value for value.
* the CUDA kernel ``csrc/conv_epilogue.cu`` — one launch that reads ``y``
  (and the residual) once and writes the result once, each fp32 step
  rounded as the eager op rounds it. Built with nvcc at first use
  (``ops/_build.py``) into a library of its own, bound with ctypes.

:func:`conv_epilogue` calls the registered op
``torch.ops.sparkdl_tpu_torch.conv_epilogue`` on every device: its CPU
implementation is the plain chain, its CUDA implementation the kernel,
which launches or raises, and its fake implementation gives the output's
shape, dtype and memory format, so ``torch.export`` and
``FakeTensorMode`` trace through it and an exported program holds the
op by name. The op has no autograd formula: the conv units call it only
where no gradient is needed. ``launches`` counts the kernel's launches;
the registry's ``model.epilogue.fused`` counts them too, beside
``model.epilogue.eager``, the conv-unit calls on the card that took the
eager chain (:func:`count_eager`).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

KERNEL = "conv_epilogue"
THREADS = 256      # threads per block, as kThreads in the kernel
VEC = 8            # bf16 per 16-byte access, as kVec
UNROLL = 2         # vectors a thread has in flight, as kUnroll
# the kernel's launch modes, as its kChannelsLast8, kPlanes8 and kScalar
MODE_CHANNELS_LAST8 = 0
MODE_PLANES8 = 1
MODE_SCALAR = 2

# kernel launches made by conv_epilogue (one per call on a CUDA tensor);
# reset and read by callers that prove the kernel ran. Several threads may
# run a model, so an increment holds _count_lock
launches = 0
_count_lock = threading.Lock()


def batchnorm(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm of [N, C, H, W] in fp32: ``(float(x) - mean) *
    mul + beta``, one op and one rounding each."""
    shape = (1, -1, 1, 1)
    v = x.to(torch.float32) - mean.view(shape)
    return v * mul.view(shape) + beta.view(shape)


def conv_epilogue_plain(y: torch.Tensor, bias: Optional[torch.Tensor],
                        mean: torch.Tensor, mul: torch.Tensor,
                        beta: torch.Tensor,
                        residual: Optional[torch.Tensor] = None,
                        relu: bool = True) -> torch.Tensor:
    """The eager chain: the bias added in bf16, ``(float(y) - mean) * mul
    + beta`` in fp32 (one op and one rounding each), the cast back to
    bf16, the residual added in bf16, then ReLU."""
    if bias is not None:
        y = y + bias.view(1, -1, 1, 1)
    t = batchnorm(y, mean, mul, beta).to(y.dtype)
    if residual is not None:
        t = t + residual
    return F.relu(t) if relu else t


def channels_last(y: torch.Tensor) -> Optional[bool]:
    """True for a channels_last tensor, False for a contiguous NCHW one
    (a tensor that is both, with one channel or one pixel, counts as
    channels_last: its elements lie in the same order either way), None
    for any other layout."""
    if y.is_contiguous(memory_format=torch.channels_last):
        return True
    if y.is_contiguous():
        return False
    return None


def _check(y, bias, mean, mul, beta, residual) -> None:
    """Raises ``ValueError`` where the arguments are not the op's: each
    implementation checks them once."""
    if y.dim() != 4:
        raise ValueError(f"conv_epilogue: y must be [N, C, H, W], got "
                         f"shape {tuple(y.shape)}")
    if y.dtype != torch.bfloat16:
        raise ValueError(f"conv_epilogue: y must be bfloat16, got {y.dtype}")
    c = y.shape[1]
    terms = [("mean", mean, torch.float32), ("mul", mul, torch.float32),
             ("beta", beta, torch.float32)]
    if bias is not None:
        terms.append(("bias", bias, torch.bfloat16))
    for name, t, dtype in terms:
        if t.dim() != 1 or t.shape[0] != c:
            raise ValueError(f"conv_epilogue: {name} must be [{c}] (y's "
                             f"channels), got shape {tuple(t.shape)}")
        if t.dtype != dtype:
            raise ValueError(f"conv_epilogue: {name} must be {dtype}, got "
                             f"{t.dtype}")
    if channels_last(y) is None:
        raise ValueError("conv_epilogue: y must be channels_last or "
                         f"contiguous, got strides {tuple(y.stride())}")
    if residual is not None:
        if residual.shape != y.shape or residual.dtype != y.dtype:
            raise ValueError(
                f"conv_epilogue: the residual must be y's shape "
                f"{tuple(y.shape)} and dtype {y.dtype}, got "
                f"{tuple(residual.shape)} {residual.dtype}")
        fmt = (torch.channels_last if channels_last(y)
               else torch.contiguous_format)
        if not residual.is_contiguous(memory_format=fmt):
            raise ValueError("conv_epilogue: the residual must be in y's "
                             "layout")


def conv_epilogue(y: torch.Tensor, bias: Optional[torch.Tensor],
                  mean: torch.Tensor, mul: torch.Tensor, beta: torch.Tensor,
                  residual: Optional[torch.Tensor] = None,
                  relu: bool = True) -> torch.Tensor:
    """bf16 [N, C, H, W] → bf16 in ``y``'s layout: the conv unit's
    inference epilogue (the module docstring's formula).

    Goes through the registered op ``sparkdl_tpu_torch::conv_epilogue``: a
    CPU tensor to :func:`conv_epilogue_plain`, a CUDA tensor to the kernel
    on the current stream, one launch per call, and a fake tensor to the
    output's metadata alone. Raises ``ValueError`` on a wrong dtype, rank,
    channel count, residual shape or layout; the kernel never falls back
    to the plain chain."""
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {y.device}")
    return torch.ops.sparkdl_tpu_torch.conv_epilogue(
        y, bias, mean, mul, beta, residual, bool(relu))


def count_eager(y: torch.Tensor) -> None:
    """Counts a conv-unit call that took the eager chain on the card."""
    if y.device.type == "cuda":
        from sparkdl_tpu_torch.obs.registry import default_registry
        default_registry().counter("model.epilogue.eager").add()


@torch.library.custom_op(
    "sparkdl_tpu_torch::conv_epilogue", mutates_args=(),
    device_types="cpu",
    schema="(Tensor y, Tensor? bias, Tensor mean, Tensor mul, Tensor beta, "
           "Tensor? residual, bool relu) -> Tensor")
def _conv_epilogue_op(y, bias, mean, mul, beta, residual, relu):
    _check(y, bias, mean, mul, beta, residual)
    out = conv_epilogue_plain(y, bias, mean, mul, beta, residual, relu)
    if out.stride() != y.stride():
        # y's strides, as the kernel's output and the fake's
        out = torch.empty_like(y).copy_(out)
    return out


@_conv_epilogue_op.register_kernel("cuda")
def _conv_epilogue_cuda(y, bias, mean, mul, beta, residual, relu):
    return _launch(y, bias, mean, mul, beta, residual, relu)


@_conv_epilogue_op.register_fake
def _conv_epilogue_fake(y, bias, mean, mul, beta, residual, relu):
    _check(y, bias, mean, mul, beta, residual)
    return torch.empty_like(y)


def _library():
    from sparkdl_tpu_torch.ops import _build
    lib = _build.load(KERNEL)
    fn = lib.conv_epilogue_launch
    if not fn.argtypes:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, p, ll, i, ll, i, i, i, i, p]
        fn.restype = i
        ip = ctypes.POINTER(ctypes.c_int)
        lib.conv_epilogue_occupancy.argtypes = [i, i, i, ip, ip, ip]
        lib.conv_epilogue_occupancy.restype = i
    return lib


@functools.lru_cache(maxsize=64)
def _occupancy(mode: int, has_bias: bool, has_res: bool,
               device: torch.device) -> Tuple[int, int, int, int]:
    """(blocks per SM, registers, local bytes per thread, SMs) of the
    kernel instance, as the card reports them."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = _library().conv_epilogue_occupancy(
            mode, int(has_bias), int(has_res),
            *(ctypes.byref(v) for v in vals))
    if err != 0 or vals[0].value < 1:
        raise RuntimeError(f"{KERNEL}: no block fits an SM (CUDA error "
                           f"{err})")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return vals[0].value, vals[1].value, vals[2].value, sms


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def launch_config(y: torch.Tensor, bias: Optional[torch.Tensor],
                  mean: torch.Tensor, mul: torch.Tensor, beta: torch.Tensor,
                  residual: Optional[torch.Tensor] = None,
                  relu: bool = True) -> dict:
    """How the kernel launches for these CUDA tensors: its mode, grid and
    threads, and what the card reports for the instance (blocks per SM,
    registers, local memory per thread)."""
    n, c, h, w = y.shape
    cl = channels_last(y)
    if cl is None:
        raise ValueError("conv_epilogue: y must be channels_last or "
                         "contiguous")
    streams = (y, residual)
    if cl and c % VEC == 0 and _aligned(*streams, bias, mean, mul, beta):
        mode = MODE_CHANNELS_LAST8
    elif not cl and (h * w) % VEC == 0 and _aligned(*streams):
        mode = MODE_PLANES8
    else:
        mode = MODE_SCALAR
    per_sm, regs, local, sms = _occupancy(mode, bias is not None,
                                          residual is not None, y.device)
    items = y.numel() if mode == MODE_SCALAR else -(-y.numel() // VEC)
    per_block = THREADS * (1 if mode == MODE_SCALAR else UNROLL)
    grid = max(1, min(-(-items // per_block), per_sm * sms))
    return {"mode": mode, "channels_last": cl, "grid": [grid, 1, 1],
            "threads": THREADS, "blocks_per_sm": per_sm,
            "registers": regs, "local_bytes": local}


def _launch(y, bias, mean, mul, beta, residual, relu) -> torch.Tensor:
    """One launch of the kernel on CUDA tensors."""
    global launches
    _check(y, bias, mean, mul, beta, residual)
    tensors = [t for t in (y, bias, mean, mul, beta, residual)
               if t is not None]
    if any(t.device != y.device for t in tensors):
        raise ValueError("conv_epilogue: every tensor must be on y's "
                         "device")
    if any(not t.is_contiguous() for t in (mean, mul, beta)) or (
            bias is not None and not bias.is_contiguous()):
        raise ValueError("conv_epilogue: the per-channel terms must be "
                         "contiguous")
    out = torch.empty_like(y)
    if out.numel() == 0:
        return out
    cfg = launch_config(y, bias, mean, mul, beta, residual, relu)
    n, c, h, w = y.shape

    def ptr(t):
        return None if t is None else t.data_ptr()
    fn = _library().conv_epilogue_launch
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(y.data_ptr(), ptr(bias), mean.data_ptr(), mul.data_ptr(),
                 beta.data_ptr(), ptr(residual), out.data_ptr(), y.numel(),
                 c, h * w, int(cfg["channels_last"]), int(relu),
                 cfg["mode"], cfg["grid"][0], stream)
    if err != 0:
        raise RuntimeError(
            f"{KERNEL} kernel launch failed with CUDA error {err}")
    with _count_lock:
        launches += 1
    from sparkdl_tpu_torch.obs.registry import default_registry
    default_registry().counter("model.epilogue.fused").add()
    return out
