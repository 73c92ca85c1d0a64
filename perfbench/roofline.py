"""The yardstick of the roofline shares: the published peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at its 700 W limit),
the work of a separable resize, and a kernel's share of its roofline
from the traced sub-window."""

import numpy as np

from perfbench.reference.infeed import triangle_weights

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12       # outside the tensor cores
BF16_DENSE_FLOPS_PER_S = 989e12


def bound_s(nbytes: int, fp32_flops: int) -> float:
    """The least time the card could take for the work."""
    return max(nbytes / HBM_BYTES_PER_S, fp32_flops / FP32_FLOPS_PER_S)


def plane_macs(src_hw, dst_hw) -> int:
    """Multiply-adds of a separable resize of one plane and channel over
    the reference weights' nonzero taps: the row pass over every source
    column, then the column pass over every output row."""
    (H, W), (h, w) = src_hw, dst_hw
    taps_h = int(np.count_nonzero(triangle_weights(H, h)))
    taps_w = int(np.count_nonzero(triangle_weights(W, w)))
    return taps_h * W + h * taps_w


def roofline_pct(record, kernel: str):
    """100 x the sum over the sub-window's calls of ``kernel`` of each
    call's bound, over their summed device time; None without a call."""
    k = record.kernel(kernel)
    calls, seconds = record.op_time(k.PATTERN)
    if not calls or seconds <= 0:
        return None
    g = record.geometry
    nbytes, flops = k.work(g["batch"], tuple(g["src_hw"]),
                           tuple(g["dst_hw"]))
    return 100.0 * calls * bound_s(nbytes, flops) / seconds
