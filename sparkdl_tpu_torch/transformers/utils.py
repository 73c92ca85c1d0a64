"""Shared transformer helpers — counterpart of
``sparkdl_tpu/transformers/utils.py`` (image packing, model-output
columns, runner selection, and the device-resize model wrapper)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.data.tensors import Batch, append_tensor_column
from sparkdl_tpu_torch.image import imageIO

IMAGE_INPUT_NAME = "image"


def packImageBatch(column: np.ndarray, height: int, width: int,
                   nChannels: int = 3, resize: bool = True) -> np.ndarray:
    """Image struct column → contiguous [N, H, W, C] uint8.

    Every row must already be (height, width, nChannels): resizing rows
    on the host is a later slice (ROADMAP "host resize in
    packImageBatch"), so ``resize=True`` with an off-size row raises
    ``NotImplementedError``; ``resize=False`` raises ``ValueError`` as
    the JAX package does. Uniformly sized images go through
    ``deviceResizeFrom`` instead, which resizes on the card."""
    n = len(column)
    out = np.empty((n, height, width, nChannels), np.uint8)
    want = (height, width, nChannels)
    for i, row in enumerate(column):
        got = (row["height"], row["width"], row["nChannels"])
        if got != want:
            if resize:
                raise NotImplementedError(
                    f"row {i}: image {got} != {want}, and host resize is "
                    "not ported yet (ROADMAP: host resize in "
                    "packImageBatch); pass deviceResizeFrom for uniformly "
                    "sized images")
            raise ValueError(f"row {i}: image {got} != {want}")
        out[i] = imageIO.imageStructToArray(row)
    return out


def appendModelOutput(batch: Batch, out_col: str,
                      out: np.ndarray) -> Batch:
    """Append a model's output as a flat float32 vector column (the JAX
    package's ``outputMode="vector"``; ``"image"`` is a later slice)."""
    out = np.asarray(out)
    width = int(np.prod(out.shape[1:])) if out.ndim > 1 else 1
    flat = out.reshape(len(out), width).astype(np.float32, copy=False)
    return append_tensor_column(batch, out_col, flat)


def make_runner(model_fn, batch_size: int, metrics=None):
    """The single-device ``BatchRunner`` (the mesh runner is a later
    slice)."""
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    return BatchRunner(model_fn, batch_size, metrics=metrics)


def round_to_uint8(y: torch.Tensor) -> torch.Tensor:
    """Round half to even (``torch.round``, as ``jnp.round``), clip to
    [0, 255], cast to uint8 — what a host resize would have produced."""
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def deviceResizeModel(model_fn, src_hw: Tuple[int, int],
                      packedFormat: str = "rgb"):
    """Wrap a single-image-input ModelFunction so the bilinear resize
    from ``src_hw`` to the model's input size runs on the device before
    the model: the CUDA resize kernel (``ops.fused_resize_normalize``)
    on the card, its plain version on the CPU. The resized float32
    image is rounded back to the model's uint8 input, so the model's
    preprocess sees what a host resize would have produced.

    Returns ``model_fn`` itself when ``src_hw`` is already its size.
    Only ``packedFormat="rgb"`` is ported; the 4:2:0 format is a later
    slice (ROADMAP queue B2)."""
    if packedFormat != "rgb":
        raise NotImplementedError(
            f"packedFormat={packedFormat!r} is not ported yet (ROADMAP "
            "queue B2: the yuv420 path); use 'rgb'")
    in_name, _ = single_io(model_fn)
    (h, w, c), in_dtype = model_fn.input_signature[in_name]
    sh, sw = int(src_hw[0]), int(src_hw[1])
    if (sh, sw) == (h, w):
        return model_fn

    def cast(y):
        if np.dtype(in_dtype) == np.uint8:
            return round_to_uint8(y)
        return y.to(torch.from_numpy(np.empty(0, in_dtype)).dtype)

    def pre(inputs):
        from sparkdl_tpu_torch.ops import fused_resize_normalize
        return {in_name: cast(fused_resize_normalize(inputs[in_name],
                                                     (h, w)))}

    from sparkdl_tpu_torch.graph.function import with_preprocessor
    return with_preprocessor(
        model_fn, pre, input_signature={in_name: ((sh, sw, c), in_dtype)},
        name=f"resize({sh}x{sw})+{model_fn.name}")


def single_io(model_fn) -> Tuple[str, str]:
    """Validate single-input/single-output and return (in_name, out_name)."""
    ins = model_fn.input_names
    if len(ins) != 1:
        raise ValueError(
            f"expected a single-input model, got inputs {ins}")
    outs = model_fn.output_names
    if len(outs) != 1:
        raise ValueError(
            f"expected a single-output model, got outputs {outs}")
    return ins[0], outs[0]
