"""The whole step's share of the card's bf16 dense peak: the reference's
FLOPs per image times the images of the window's passes outside the
profiled sub-window, over those passes' seconds on the host's clock, in
%. The convs run in bf16 on the tensor cores."""

from perfbench.roofline import BF16_DENSE_FLOPS_PER_S


def read(rec):
    if not rec.plain_images or not rec.flops_per_image:
        return None
    rate = rec.flops_per_image * rec.plain_images / rec.plain_s
    return 100.0 * rate / BF16_DENSE_FLOPS_PER_S
