"""The fused attention of SigLIP so400m's blocks and of its pooling head
(``layers.attention``: ``F.scaled_dot_product_attention`` limited to its
flash, memory-efficient and cuDNN kernels): softmax(q kᵀ / √d) v of
``queries`` query rows over the 729 tokens, per image and head.

The work is what the step needs, whatever implements it: 4·H·Nq·N·d
FLOPs an image (the two products; the softmax is not counted), and q, k
and v read once and the output written once, in bf16. Every encoder
block makes one call over the batch (Nq = N = 729); the head makes one
more with Nq = 1, counted where the same kernel runs it."""

from perfbench.reference.siglip_so400m import (
    HEADS,
    HIDDEN,
    IMAGE,
    LAYERS,
    PATCH,
)
from perfbench.roofline import BF16_DENSE_FLOPS_PER_S, HBM_BYTES_PER_S

# the kernel's name in the device trace: PyTorch 2.11 on the H100 runs
# cuDNN's fused attention, cudnn_generated_fort_native_sdpa_sm90_flash_*
# for the blocks and an sm80 instance for the head's single query
PATTERN = "native_sdpa"
TOKENS = (IMAGE // PATCH) ** 2
HEAD_DIM = HIDDEN // HEADS
ENCODER_CALLS = LAYERS          # per batch; the head's call is one more
BF16 = 2


def work(batch: int, queries: int = TOKENS):
    """(bytes, FLOPs) of one call over ``batch`` images."""
    flops = 4 * batch * HEADS * queries * TOKENS * HEAD_DIM
    nbytes = BF16 * batch * HEADS * HEAD_DIM * (2 * queries + 2 * TOKENS)
    return nbytes, flops


def bound_s(nbytes: int, flops: int) -> float:
    """The least time the card could take for the work, in bf16 on the
    tensor cores."""
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_DENSE_FLOPS_PER_S)
