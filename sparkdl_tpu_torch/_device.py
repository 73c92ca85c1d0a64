"""Device resolution shared by every entry point of the port.

``None`` means the card. A caller that wants the CPU says so; the port
never falls back to it quietly, because a pipeline that silently ran on
the host would report host numbers as the card's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be a CUDA device or 'cpu', got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default "
            "and does not fall back to the CPU; pass device='cpu' to run "
            "on the CPU")
    return dev
