"""Shared transformer helpers — counterpart of
``sparkdl_tpu/transformers/utils.py`` (image packing, model-output
columns as vectors or image structs, the payload-to-model reshape guards,
runner selection, and the device-resize model wrapper)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sparkdl_tpu_torch.data.frame import to_column
from sparkdl_tpu_torch.data.tensors import (
    Batch,
    append_tensor_column,
    append_unique_column,
)
from sparkdl_tpu_torch.image import imageIO
from sparkdl_tpu_torch.ops.infeed import round_to_uint8

IMAGE_INPUT_NAME = "image"


def packImageBatch(column: np.ndarray, height: int, width: int,
                   nChannels: int = 3, resize: bool = True) -> np.ndarray:
    """Image struct column → contiguous [N, H, W, C] uint8, resizing rows
    on the host as needed: all rows in one call of the native shim
    (bilinear, OpenMP over rows) when it is built, else the off-size rows
    one by one through PIL (``imageIO.resizeImageArray``). The two
    resamplers differ by a few counts when downscaling, as in the JAX
    package. ``resize=False`` raises ``ValueError`` on the first off-size
    row."""
    want = (height, width, nChannels)
    if all(row is not None and (row["height"], row["width"],
                                row["nChannels"]) == want
           for row in column):
        return _pack_at_size(column, want)
    arrays = [imageIO.imageStructToArray(row) for row in column]
    off = [i for i, a in enumerate(arrays) if a.shape != want]
    if not resize:
        i = off[0]
        raise ValueError(f"row {i}: image {arrays[i].shape} != {want}")

    from sparkdl_tpu_torch import native
    packed = native.resize_pack_batch(arrays, height, width, nChannels)
    if packed is not None:
        return packed
    out = np.empty((len(arrays),) + want, np.uint8)
    for i, a in enumerate(arrays):
        out[i] = (imageIO.resizeImageArray(a, height, width, nChannels)
                  if a.shape != want else a)
    return out


def _pack_at_size(column: np.ndarray, want) -> np.ndarray:
    """Rows already at the model's size → [N, H, W, C] uint8: each
    struct's bytes go straight into the output through a byte view (no
    per-row array) — the port's counterpart of the JAX package's
    ``imageColumnViews`` over Arrow buffers."""
    row_bytes = int(np.prod(want))
    out = np.empty((len(column),) + tuple(want), np.uint8)
    view = memoryview(out.reshape(-1))   # flat bytes, zero rows too
    for i, row in enumerate(column):
        data = row["data"]
        if len(data) != row_bytes:
            raise ValueError(
                f"row {i}: data size {len(data)} != h*w*c = "
                f"{'*'.join(map(str, want))}")
        view[i * row_bytes:(i + 1) * row_bytes] = data
    return out


def outputToImageStructs(array: np.ndarray, origins=None) -> np.ndarray:
    """Float/uint8 [N, H, W, C] model output → image struct column (an
    object array of the port's struct dicts): a non-uint8 output is
    rounded (half to even), clipped to 0..255 and cast, as in the JAX
    package."""
    array = np.asarray(array)
    if array.ndim != 4:
        raise ValueError(
            f"image output mode needs [N,H,W,C] output, got {array.shape}")
    if array.dtype != np.uint8:
        array = np.clip(np.round(array), 0, 255).astype(np.uint8)
    return to_column([
        imageIO.imageArrayToStruct(
            arr, origin=origins[i] if origins is not None else "")
        for i, arr in enumerate(array)])


def appendModelOutput(batch: Batch, out_col: str, out: np.ndarray,
                      mode: str = "vector", origins=None) -> Batch:
    """Append a model's output as a flat float32 vector column
    (``mode="vector"``) or an image struct column (``"image"``)."""
    out = np.asarray(out)
    if mode == "image":
        return append_unique_column(batch, out_col,
                                    outputToImageStructs(out, origins))
    width = int(np.prod(out.shape[1:])) if out.ndim > 1 else 1
    flat = out.reshape(len(out), width).astype(np.float32, copy=False)
    return append_tensor_column(batch, out_col, flat)


def reshapeRows(arr, shape, dtype, describe_mismatch) -> np.ndarray:
    """``[N, *row_shape]`` → ``[N, *shape]`` + dtype cast, with an error
    that names both sides on an element-count mismatch (the bare numpy
    reshape error names neither). Dynamic (None) dims skip the reshape;
    zero-row chunks reshape legally, while N > 0 rows of a wrong count
    raise ``ValueError(describe_mismatch(row_shape, got, expect))``."""
    arr = np.asarray(arr)
    static = shape and all(d is not None for d in shape)
    if static and arr.shape[1:] != tuple(shape):
        expect = int(np.prod(shape))
        got = int(np.prod(arr.shape[1:], dtype=np.int64))
        if got != expect and arr.shape[0] > 0:
            raise ValueError(describe_mismatch(arr.shape[1:], got,
                                               expect))
        arr = arr.reshape((arr.shape[0],) + tuple(shape))
    return arr.astype(dtype, copy=False)


def reshapeLoadedRows(arr, shape, dtype, model_name: str) -> np.ndarray:
    """:func:`reshapeRows` with the imageLoader seam's message (the Keras
    image transformer)."""
    return reshapeRows(
        arr, shape, dtype,
        lambda row_shape, got, expect: (
            f"imageLoader rows carry shape {row_shape} ({got} "
            f"elements) but model {model_name!r} expects input shape "
            f"{tuple(shape)} ({expect} elements); make the loader "
            "emit the model's input size"))


def make_runner(model_fn, batch_size: int, metrics=None):
    """The single-device ``BatchRunner`` (the mesh runner is a later
    slice). Its strategy, prefetch depth and infeed ring come from the
    environment or the runner's defaults, as in the JAX package."""
    from sparkdl_tpu_torch.runtime.runner import BatchRunner
    return BatchRunner(model_fn, batch_size, metrics=metrics)


def deviceResizeModel(model_fn, src_hw: Tuple[int, int],
                      use_pallas=None, packedFormat: str = "rgb"):
    """Wrap a single-image-input ModelFunction so the bilinear resize
    from ``src_hw`` to the model's input size runs on the device before
    the model, as a CUDA kernel on the card and its plain version on the
    CPU. The resized image is rounded back to the model's uint8 input
    (half to even), so the model's preprocess sees what a host resize
    would have produced.

    ``packedFormat``: ``"rgb"`` takes ``[N, sh, sw, c]`` uint8 rows
    (``ops.fused_resize_normalize``, kernel K1) and returns ``model_fn``
    itself when ``src_hw`` is already its size; ``"yuv420"`` takes the
    packed planar 4:2:0 rows ``[N, sh*sw*3/2]`` that
    ``readImagesPacked(..., packedFormat="yuv420")`` ships, and
    reconstructs RGB on the device (``ops.fused_yuv420_resize_normalize``,
    kernel K2), which for a uint8 model input also does the round.

    ``use_pallas`` is kept for the JAX package's signature: only its
    ``"rgb"`` op has a Pallas kernel, so with ``"yuv420"`` a true value
    raises, as it does there; with ``"rgb"`` it is ignored (the card
    always runs K1)."""
    in_name, _ = single_io(model_fn)
    (h, w, c), in_dtype = model_fn.input_signature[in_name]
    sh, sw = int(src_hw[0]), int(src_hw[1])
    u8 = np.dtype(in_dtype) == np.uint8
    torch_dtype = torch.from_numpy(np.empty(0, in_dtype)).dtype

    def cast(y):
        return round_to_uint8(y) if u8 else y.to(torch_dtype)

    if packedFormat == "yuv420":
        if use_pallas:
            raise ValueError(
                "use_pallas is not supported with packedFormat="
                "'yuv420' (the 4:2:0 reconstruction op is XLA-only)")
        if c != 3:
            raise ValueError(
                f"yuv420 input needs a 3-channel model, got {c}")
        from sparkdl_tpu_torch.native import yuv420_packed_size
        in_sig = ((yuv420_packed_size(sh, sw),), np.uint8)
        label = "yuv420"

        def pre(inputs):
            from sparkdl_tpu_torch.ops import fused_yuv420_resize_normalize
            # a uint8 model input takes the kernel's fused round
            return fused_yuv420_resize_normalize(
                inputs[in_name], (sh, sw), (h, w),
                out_dtype=torch.uint8 if u8 else torch.float32
            ).to(torch_dtype)
    elif packedFormat == "rgb":
        if (sh, sw) == (h, w):
            return model_fn
        in_sig = ((sh, sw, c), in_dtype)
        label = "resize"

        def pre(inputs):
            from sparkdl_tpu_torch.ops import fused_resize_normalize
            return cast(fused_resize_normalize(inputs[in_name], (h, w)))
    else:
        raise ValueError(f"packedFormat must be 'rgb' or 'yuv420', "
                         f"got {packedFormat!r}")

    from sparkdl_tpu_torch.graph.function import with_preprocessor
    return with_preprocessor(
        model_fn, lambda inputs: {in_name: pre(inputs)},
        input_signature={in_name: in_sig},
        name=f"{label}({sh}x{sw})+{model_fn.name}")


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
