"""K2 (``ops/csrc/yuv420_resize_normalize.cu``): packed planar 4:2:0
rows [n, H*W*3/2] to RGB at the model's size, rounded to its uint8
input.

The work is each source byte read once and each byte of the model's
uint8 input written once; the float32 multiply-adds of each plane's two
passes (the luma plane from H x W, both chroma planes from H/2 x W/2)
and 10 operations a pixel of colour conversion."""

from perfbench.roofline import plane_macs

PATTERN = "yuv420_kernel"   # the kernel's name in the device trace
COLOUR_FLOPS = 10           # per output pixel: 4 products, 6 sums


def work(batch: int, src_hw, dst_hw):
    """(bytes, FLOPs) of one call."""
    (H, W), (h, w) = src_hw, dst_hw
    nbytes = batch * (H * W * 3 // 2 + h * w * 3)
    macs = plane_macs((H, W), dst_hw) + 2 * plane_macs((H // 2, W // 2),
                                                       dst_hw)
    flops = batch * (2 * macs + COLOUR_FLOPS * h * w)
    return nbytes, flops
