"""Device ops of the port: each op has a hand-written CUDA kernel for
tensors on the card and a plain PyTorch version of the same function,
which the wrapper takes only for tensors on the CPU."""

from sparkdl_tpu_torch.ops.infeed import (  # noqa: F401
    bilinear_weight_matrix,
    fused_resize_normalize,
    fused_resize_normalize_plain,
    fused_yuv420_resize_normalize,
    fused_yuv420_resize_normalize_plain,
    round_to_uint8,
    yuv420_unpack,
)
from sparkdl_tpu_torch.ops.epilogue import (  # noqa: F401
    conv_epilogue,
    conv_epilogue_plain,
)
