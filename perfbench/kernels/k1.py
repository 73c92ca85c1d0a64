"""K1 (``ops/csrc/resize_normalize.cu``): uint8 RGB rows [n, H, W, 3]
resized to the model's size and rounded to its uint8 input.

The work is what the step needs, whatever implements it: each source
byte read once and each byte of the model's uint8 input written once
(not K1's float32 output, so a round-cast fused into the kernel is
credited as a faster kernel, never counted twice); the float32
multiply-adds of the two passes over the weights' nonzero taps."""

from perfbench.roofline import plane_macs

PATTERN = "resize_kernel"   # the kernel's name in the device trace


def work(batch: int, src_hw, dst_hw, channels: int = 3):
    """(bytes, FLOPs) of one call."""
    (H, W), (h, w) = src_hw, dst_hw
    nbytes = batch * channels * (H * W + h * w)
    flops = 2 * batch * channels * plane_macs(src_hw, dst_hw)
    return nbytes, flops
