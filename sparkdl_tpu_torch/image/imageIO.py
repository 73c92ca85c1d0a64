"""Image file reading, codecs and the image struct — counterpart of
``sparkdl_tpu/image/imageIO.py`` (``imageArrayToStruct``,
``imageStructToArray``, ``readImages``, ``readImagesPacked``,
``resizeImageArray``, ``rgbToYuv420``, ``yuv420ToRgb``).

An image struct is a dict with the six fields of the JAX package's Arrow
struct (Spark ImageSchema's order): ``origin``, ``height``, ``width``,
``nChannels``, ``mode`` (OpenCV type code) and ``data`` (HWC uint8 RGB
bytes). An image column is an object array of such dicts (None where a
file failed to decode). ``readImagesPacked`` decodes JPEGs with the
native shim (``sparkdl_tpu_torch/native``); everything else is decoded
with PIL, imported only inside the decode step.
"""

from __future__ import annotations

import glob
import io
import os
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sparkdl_tpu_torch.data.frame import (
    ConstantLoad,
    DataFrame,
    Source,
    column,
    to_column,
)

ocvTypes = {
    "Undefined": -1,
    "CV_8U": 0, "CV_8UC1": 0,
    "CV_8UC3": 16,
    "CV_8UC4": 24,
}

_MODE_BY_CHANNELS = {1: ocvTypes["CV_8UC1"], 3: ocvTypes["CV_8UC3"],
                     4: ocvTypes["CV_8UC4"]}

# field name → type of one image struct
imageFields = {"origin": str, "height": int, "width": int,
               "nChannels": int, "mode": int, "data": bytes}
imageSchema = {"image": imageFields}

_PIL_MODE_BY_CHANNELS = {1: "L", 3: "RGB", 4: "RGBA"}

_SUPPORTED_EXTENSIONS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".ppm",
                         ".tif", ".tiff", ".webp")

_JPEG_MAGIC = b"\xff\xd8\xff"


def imageArrayToStruct(imgArray: np.ndarray, origin: str = "") -> dict:
    """HWC uint8 ndarray → image struct dict."""
    arr = np.asarray(imgArray)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.ndim != 3:
        raise ValueError(f"expected HWC array, got shape {arr.shape}")
    if arr.dtype != np.uint8:
        if np.issubdtype(arr.dtype, np.floating) and arr.max() <= 1.0 + 1e-6:
            arr = (arr * 255).round()
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    h, w, c = arr.shape
    if c not in _MODE_BY_CHANNELS:
        raise ValueError(f"unsupported channel count {c}")
    return {
        "origin": origin,
        "height": int(h),
        "width": int(w),
        "nChannels": int(c),
        "mode": _MODE_BY_CHANNELS[c],
        "data": np.ascontiguousarray(arr).tobytes(),
    }


def imageStructToArray(imageRow: dict) -> np.ndarray:
    """Image struct dict → HWC uint8 ndarray (a view of its bytes)."""
    h, w, c = imageRow["height"], imageRow["width"], imageRow["nChannels"]
    arr = np.frombuffer(imageRow["data"], dtype=np.uint8)
    if arr.size != h * w * c:
        raise ValueError(
            f"data size {arr.size} != h*w*c = {h}*{w}*{c}")
    return arr.reshape(h, w, c)


def _decodeImage(imageData: bytes, origin: str = "") -> Optional[dict]:
    """Decode compressed bytes with PIL → image struct (None on failure)."""
    from PIL import Image, UnidentifiedImageError
    try:
        img = Image.open(io.BytesIO(imageData))
        if img.mode not in ("L", "RGB", "RGBA"):
            img = img.convert("RGB")
        arr = np.asarray(img)
    except (OSError, ValueError, SyntaxError, UnidentifiedImageError):
        return None
    return imageArrayToStruct(arr, origin=origin)


def listImageFiles(path: str) -> List[str]:
    """Expand a file, directory (recursively), or glob pattern into image
    file paths, sorted."""
    if os.path.isfile(path):
        return [path]
    if os.path.isdir(path):
        files = glob.glob(os.path.join(path, "**"), recursive=True)
    else:
        files = glob.glob(path, recursive=True)
    return [f for f in sorted(files)
            if os.path.isfile(f)
            and f.lower().endswith(_SUPPORTED_EXTENSIONS)]


@dataclasses.dataclass(frozen=True)
class ReadFiles:
    """A ``filesToDF`` partition's ``load``: these files' bytes."""
    paths: tuple

    def __call__(self):
        datas = []
        for p in self.paths:
            with open(p, "rb") as f:
                datas.append(f.read())
        return {"filePath": to_column([str(p) for p in self.paths]),
                "fileData": to_column(datas)}


def filesToDF(paths: Sequence[str], numPartitions: int = 8,
              engine=None) -> DataFrame:
    """File paths → DataFrame[filePath, fileData], read lazily per
    partition."""
    paths = list(paths)
    numPartitions = max(1, min(numPartitions, max(1, len(paths))))
    chunks = [c for c in np.array_split(np.asarray(paths, dtype=object),
                                        numPartitions) if len(c)]
    sources = [Source(ReadFiles(tuple(str(p) for p in c)), len(c))
               for c in chunks]
    if not sources:
        empty = {"filePath": to_column([]), "fileData": to_column([])}
        sources = [Source(ConstantLoad(empty), 0)]
    return DataFrame(sources, engine=engine)


def decodeImages(batch):
    """``readImages``' decode stage: [filePath, fileData] → [filePath,
    image struct], None where a file does not decode."""
    paths = column(batch, "filePath")
    structs = [_decodeImage(blob, origin=str(p))
               for p, blob in zip(paths, column(batch, "fileData"))]
    return {"filePath": paths, "image": to_column(structs)}


def imageDecoded(batch) -> np.ndarray:
    """The rows whose image decoded (``readImages``' failure filter)."""
    return np.array([s is not None for s in column(batch, "image")],
                    dtype=bool)


def readImages(imageDirectory: str, numPartitions: int = 8,
               dropImageFailures: bool = True, engine=None) -> DataFrame:
    """Read images under a directory/glob into
    DataFrame[filePath, image-struct], decoded lazily per partition on
    the engine's host threads (``engine``: the default engine unless
    given). Files that fail to decode are dropped
    (``dropImageFailures``) or kept as None."""
    df = filesToDF(listImageFiles(imageDirectory),
                   numPartitions=numPartitions, engine=engine)
    df = df.map_batches(decodeImages, name="decodeImage")
    if dropImageFailures:
        df = df.filter(imageDecoded)
    return df


def _validate_size(height: int, width: int) -> None:
    """Zero dims degenerate to silently empty tensors: refuse them."""
    if height <= 0 or width <= 0:
        raise ValueError(
            f"size must be positive, got {height}x{width}")


def resizeImageArray(arr: np.ndarray, height: int, width: int,
                     nChannels: Optional[int] = None) -> np.ndarray:
    """Bilinear resize via PIL, with channel conversion to ``nChannels``
    — the per-row path. Batch call sites (``packImageBatch``) use the
    native shim when it is built and fall back here."""
    from PIL import Image
    c = arr.shape[2]
    if nChannels is not None and nChannels != c:
        if c == 1 and nChannels == 3:
            arr = np.repeat(arr, 3, axis=2)
        elif c == 4 and nChannels == 3:
            arr = arr[:, :, :3]
        elif c in (3, 4) and nChannels == 1:
            pil = Image.fromarray(arr[:, :, :3], "RGB").convert("L")
            arr = np.asarray(pil)[:, :, None]
        else:
            raise ValueError(f"cannot convert {c} channels to {nChannels}")
        c = nChannels
    if arr.shape[0] == height and arr.shape[1] == width:
        return arr
    pil = Image.fromarray(arr.squeeze(-1) if c == 1 else arr,
                          _PIL_MODE_BY_CHANNELS[c])
    pil = pil.resize((width, height), Image.BILINEAR)
    out = np.asarray(pil)
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def _draftDecodeResize(blob: bytes, height: int, width: int,
                       nChannels: int) -> Optional[np.ndarray]:
    """PIL twin of the shim's DCT-prescaled decode: ``draft`` picks a
    power-of-two prescale by the same rule the shim's
    ``choose_scale_num`` uses, so ``scaledDecode=True`` means the same
    on a host without the shim. Returns None when the blob cannot be
    handled (the caller then takes the general decode route)."""
    from PIL import Image
    try:
        im = Image.open(io.BytesIO(blob))
        im.draft("L" if nChannels == 1 else "RGB", (width, height))
        im = im.convert("L" if nChannels == 1 else "RGB")
        arr = np.asarray(im)
    except (OSError, ValueError, SyntaxError):
        return None
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return resizeImageArray(arr, height, width, nChannels)


def rgbToYuv420(arr: np.ndarray) -> np.ndarray:
    """RGB HWC uint8 → packed planar YCbCr 4:2:0 flat uint8 (Y[H*W] ++
    Cb ++ Cr, 2×2 box-averaged chroma, BT.601 full range — the same
    codec as the native shim's ``rgb_to_yuv420``). Dims must be even."""
    arr = np.asarray(arr)
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError(f"expected HWC RGB uint8, got {arr.shape} "
                         f"{arr.dtype}")
    h, w, _ = arr.shape
    if h <= 0 or w <= 0 or h % 2 or w % 2:
        raise ValueError(
            f"yuv420 packing needs positive even dims, got {h}x{w}")
    f = arr.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    # chroma averages in float before the uint8 round (as the shim does)
    cb2 = cb.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    cr2 = cr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    def _q(p):
        return np.clip(np.floor(p + 0.5), 0, 255).astype(np.uint8)

    return np.concatenate([_q(y).reshape(-1), _q(cb2).reshape(-1),
                           _q(cr2).reshape(-1)])


def yuv420ToRgb(packed: np.ndarray, height: int, width: int) -> np.ndarray:
    """Packed planar 4:2:0 flat uint8 → RGB HWC uint8 by nearest chroma
    replication — the host inverse, for tests and debugging (the device
    op ``ops.fused_yuv420_resize_normalize`` interpolates)."""
    from sparkdl_tpu_torch.ops.infeed import _CB_B, _CB_G, _CR_G, _CR_R
    q = (height // 2) * (width // 2)
    y = packed[:height * width].astype(np.float32).reshape(height, width)
    cb = packed[height * width:height * width + q].astype(np.float32)
    cr = packed[height * width + q:].astype(np.float32)
    cb = np.repeat(np.repeat(cb.reshape(height // 2, width // 2), 2, 0),
                   2, 1) - 128.0
    cr = np.repeat(np.repeat(cr.reshape(height // 2, width // 2), 2, 0),
                   2, 1) - 128.0
    r = y + _CR_R * cr
    g = y + _CB_G * cb + _CR_G * cr
    b = y + _CB_B * cb
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.floor(rgb + 0.5), 0, 255).astype(np.uint8)


@dataclasses.dataclass(frozen=True)
class DecodeResizePack:
    """``readImagesPacked``' stage: [filePath, fileData] → [filePath,
    image] (uint8 rows of ``height × width × nChannels``, or of
    ``row_bytes`` packed 4:2:0 with ``yuv``), plus ``imageOk`` when
    failures are kept."""
    height: int
    width: int
    nChannels: int
    yuv: bool
    row_bytes: int
    threads: int
    scaledDecode: bool
    dropImageFailures: bool

    def __call__(self, batch):
        height, width, nChannels = self.height, self.width, self.nChannels
        yuv, row_bytes, threads = self.yuv, self.row_bytes, self.threads
        scaledDecode = self.scaledDecode
        dropImageFailures = self.dropImageFailures
        from sparkdl_tpu_torch import native
        fp = column(batch, "filePath")
        blobs = list(column(batch, "fileData"))
        n = len(blobs)
        out = np.zeros((n, row_bytes) if yuv
                       else (n, height, width, nChannels), np.uint8)
        ok = np.zeros(n, bool)

        jpeg_idx = [i for i, b in enumerate(blobs) if b[:3] == _JPEG_MAGIC]
        if jpeg_idx:
            sel = [blobs[i] for i in jpeg_idx]
            fused = (native.decode_resize_pack_420(
                        sel, height, width, num_threads=threads,
                        scaled_decode=scaledDecode)
                     if yuv else
                     native.decode_resize_pack(
                        sel, height, width, nChannels, num_threads=threads,
                        scaled_decode=scaledDecode))
            if fused is not None:
                packed, okm = fused
                idx = np.asarray(jpeg_idx)[okm]
                out[idx] = packed[okm]
                ok[idx] = True
        for i in np.flatnonzero(~ok):
            arr = None
            if scaledDecode and blobs[i][:3] == _JPEG_MAGIC:
                arr = _draftDecodeResize(blobs[i], height, width, nChannels)
            if arr is None:
                s = _decodeImage(blobs[i], origin=str(fp[i]))
                if s is None:
                    continue
                arr = resizeImageArray(imageStructToArray(s), height,
                                       width, nChannels)
            out[i] = rgbToYuv420(arr) if yuv else arr
            ok[i] = True

        if dropImageFailures:
            return {"filePath": fp[ok], "image": out[ok]}
        return {"filePath": fp, "image": out, "imageOk": ok}


def readImagesPacked(imageDirectory: str, size: Tuple[int, int],
                     nChannels: int = 3, numPartitions: int = 8,
                     dropImageFailures: bool = True,
                     engine=None,
                     decodeThreads: Optional[int] = None,
                     packedFormat: str = "rgb",
                     scaledDecode: bool = True) -> DataFrame:
    """Read images straight into a fixed-size uint8 tensor column
    ``image``: decode → resize → pack in one native call per partition
    for JPEGs (the C++ shim with libjpeg and OpenMP), per row through
    PIL for other files and for rows the shim could not decode. Consume
    with ``TensorTransformer(inputMapping={"image": ...})``.

    ``packedFormat``: ``"rgb"`` ships ``[h, w, c]`` uint8 rows;
    ``"yuv420"`` ships packed planar YCbCr 4:2:0 rows of ``h*w*3/2``
    bytes, half the bytes, with the chroma left at half resolution;
    consume those with ``deviceResizeModel(..., packedFormat="yuv420")``,
    whose device op reconstructs RGB. It needs even dims and
    ``nChannels=3``.

    ``scaledDecode`` (default True): libjpeg decodes at the smallest
    power-of-two M/8 of the source that still covers ``size`` (PIL's
    ``draft`` rule on the PIL path), so the bilinear step shrinks by
    less than 2x; pass False for pixels resized from the full-resolution
    decode.

    ``decodeThreads``: OpenMP threads of each partition's native call.
    None divides the host's cores by the partitions the engine decodes
    at once (its ``num_workers``, at most the partition count), so the
    engine's threads times OpenMP's do not oversubscribe the cores; 0
    means OpenMP's default (all cores).

    Files that fail to decode are dropped (``dropImageFailures``) or kept
    as zero rows beside a False in an ``imageOk`` column. Raises
    ImportError when a row needs PIL and PIL is not installed."""
    height, width = int(size[0]), int(size[1])
    _validate_size(height, width)
    if packedFormat not in ("rgb", "yuv420"):
        raise ValueError(f"packedFormat must be 'rgb' or 'yuv420', "
                         f"got {packedFormat!r}")
    yuv = packedFormat == "yuv420"
    if yuv:
        if nChannels != 3:
            raise ValueError("packedFormat='yuv420' requires nChannels=3")
        from sparkdl_tpu_torch.native import yuv420_packed_size
        row_bytes = yuv420_packed_size(height, width)  # validates even
    df = filesToDF(listImageFiles(imageDirectory),
                   numPartitions=numPartitions, engine=engine)
    if decodeThreads is None:
        cores = os.cpu_count() or 1
        workers = getattr(df._engine, "num_workers", None) or cores
        threads = max(1, cores // max(1, min(df.num_partitions, workers)))
    else:
        threads = decodeThreads

    stage = DecodeResizePack(height, width, nChannels, yuv,
                             row_bytes if yuv else 0, threads,
                             scaledDecode, dropImageFailures)
    return df.map_batches(stage, name="decodeResizePack",
                          row_preserving=not dropImageFailures)
