"""Image file reading and the image struct — counterpart of
``sparkdl_tpu/image/imageIO.py`` (``imageArrayToStruct``,
``imageStructToArray``, ``readImages``).

An image struct is a dict with the six fields of the JAX package's Arrow
struct (Spark ImageSchema's order): ``origin``, ``height``, ``width``,
``nChannels``, ``mode`` (OpenCV type code) and ``data`` (HWC uint8 RGB
bytes). An image column is an object array of such dicts (None where a
file failed to decode). Files are decoded with PIL, imported only inside
the decode step.
"""

from __future__ import annotations

import glob
import io
import os
from typing import List, Optional, Sequence

import numpy as np

from sparkdl_tpu_torch.data.frame import DataFrame, Source, column, to_column

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

_SUPPORTED_EXTENSIONS = (".jpg", ".jpeg", ".png", ".gif", ".bmp", ".ppm",
                         ".tif", ".tiff", ".webp")


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


def filesToDF(paths: Sequence[str], numPartitions: int = 8) -> DataFrame:
    """File paths → DataFrame[filePath, fileData], read lazily per
    partition."""
    paths = list(paths)
    numPartitions = max(1, min(numPartitions, max(1, len(paths))))
    chunks = [c for c in np.array_split(np.asarray(paths, dtype=object),
                                        numPartitions) if len(c)]

    def _make_load(chunk):
        def _load():
            datas = []
            for p in chunk:
                with open(p, "rb") as f:
                    datas.append(f.read())
            return {"filePath": to_column([str(p) for p in chunk]),
                    "fileData": to_column(datas)}
        return _load

    sources = [Source(_make_load(c), len(c)) for c in chunks]
    if not sources:
        empty = {"filePath": to_column([]), "fileData": to_column([])}
        sources = [Source(lambda: empty, 0)]
    return DataFrame(sources)


def readImages(imageDirectory: str, numPartitions: int = 8,
               dropImageFailures: bool = True) -> DataFrame:
    """Read images under a directory/glob into
    DataFrame[filePath, image-struct], decoded lazily per partition.
    Files that fail to decode are dropped (``dropImageFailures``) or
    kept as None."""
    df = filesToDF(listImageFiles(imageDirectory),
                   numPartitions=numPartitions)

    def _decode(batch):
        paths = column(batch, "filePath")
        structs = [_decodeImage(blob, origin=str(p))
                   for p, blob in zip(paths, column(batch, "fileData"))]
        return {"filePath": paths, "image": to_column(structs)}

    df = df.map_batches(_decode, name="decodeImage")
    if dropImageFailures:
        df = df.filter(lambda batch: np.array(
            [s is not None for s in column(batch, "image")], dtype=bool))
    return df
