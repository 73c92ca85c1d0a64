"""Native host shim: JPEG decode, resize and pack in C++ — counterpart of
``sparkdl_tpu/native/__init__.py`` for the entry points the port uses.

``sparkdl_host.cpp`` is the JAX package's shim source, copied. It is
compiled with the ambient ``g++`` (``-O3 -fopenmp``) at first use into
``sparkdl_tpu_torch/_build/`` — a directory git ignores — under a name
that says whether it links libjpeg and carries a hash of the source and
its flags, so an edited source is rebuilt and a stale library is never
loaded. Each process first builds or loads the libjpeg library; only if
that fails does it take the one without, whose JPEG entry points then
report themselves unavailable. So a machine that gains libjpeg gets it,
and one without never loads a library that links it. Every function
returns None where the shim (or its libjpeg) is unavailable, and
callers fall back to PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "sparkdl_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17"]
# with libjpeg first, then without: (name tag, flags)
_ATTEMPTS = (("jpeg", ["-DSDL_HAVE_JPEG", *_FLAGS, "-ljpeg"]),
             ("nojpeg", _FLAGS))

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path(tag: str, flags: Sequence[str]) -> str:
    """Where the shim built with ``flags`` goes: its name carries ``tag``
    and a hash of the source and of those flags."""
    digest = hashlib.sha256(repr(list(flags)).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(
        BUILD_DIR, f"libsparkdl_host-{tag}-{digest.hexdigest()[:16]}.so")


def _build(out: str, flags: Sequence[str]) -> None:
    # compile to a temp path and rename into place: the rename is atomic,
    # so a concurrent process never loads a partly written library
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    # the libraries follow the source on the command line
    libs = [f for f in flags if f.startswith("-l")]
    cmd = ["g++", *[f for f in flags if not f.startswith("-l")], _SRC,
           "-o", tmp, *libs]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    pp = ctypes.POINTER(ctypes.c_void_p)
    pi64 = ctypes.POINTER(ctypes.c_int64)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.c_int32
    lib.sdl_has_jpeg.restype = ctypes.c_int
    lib.sdl_has_jpeg.argtypes = []
    lib.sdl_resize_pack_batch.restype = ctypes.c_int
    lib.sdl_resize_pack_batch.argtypes = [
        pp, pi32, pi32, pi32, ctypes.c_int64, ctypes.c_void_p,
        i32, i32, i32, i32]
    lib.sdl_decode_resize_pack_v3.restype = ctypes.c_int
    lib.sdl_decode_resize_pack_v3.argtypes = [
        pp, pi64, ctypes.c_int64, ctypes.c_void_p, i32, i32, i32, pu8,
        i32, i32]
    lib.sdl_decode_resize_pack_420_v3.restype = ctypes.c_int
    lib.sdl_decode_resize_pack_420_v3.argtypes = [
        pp, pi64, ctypes.c_int64, ctypes.c_void_p, i32, i32, pu8, i32,
        i32]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded shim, built on first call; None when it cannot be
    built or loaded."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        err = None
        for tag, flags in _ATTEMPTS:
            path = library_path(tag, flags)
            try:
                if not os.path.exists(path):
                    _build(path, flags)
                _lib = _bind(ctypes.CDLL(path))
                return _lib
            except (OSError, subprocess.SubprocessError) as e:
                err = e
        logger.warning("native shim build or load failed (%s); using the "
                       "PIL host path", err)
        return None


def has_jpeg() -> bool:
    """Whether the shim was built, and built with libjpeg."""
    lib = get_lib()
    return bool(lib is not None and lib.sdl_has_jpeg())


def _blob_ptrs(blobs: Sequence[bytes]):
    n = len(blobs)
    ptrs = (ctypes.c_void_p * n)()
    lens = np.empty(n, np.int64)
    refs = []  # keeps the buffers alive over the call
    for i, b in enumerate(blobs):
        buf = np.frombuffer(b, np.uint8)
        refs.append(buf)
        ptrs[i] = buf.ctypes.data
        lens[i] = len(b)
    return ptrs, lens, refs


def decode_resize_pack(blobs: Sequence[bytes], height: int, width: int,
                       nChannels: int = 3, num_threads: int = 0,
                       scaled_decode: bool = False) -> Optional[tuple]:
    """JPEG decode → bilinear resize → channel convert → contiguous
    ``[N, H, W, C]`` uint8, in one native call (OpenMP over images).
    ``scaled_decode`` lets libjpeg decode at the smallest power-of-two
    M/8 of the source that still covers (H, W). Returns
    ``(batch, ok_mask)``, or None without the shim's libjpeg."""
    if not has_jpeg():
        return None
    lib = get_lib()
    n = len(blobs)
    out = np.zeros((n, height, width, nChannels), np.uint8)
    ok = np.zeros(n, np.uint8)
    if n == 0:
        return out, ok.astype(bool)
    ptrs, lens, refs = _blob_ptrs(blobs)
    lib.sdl_decode_resize_pack_v3(
        ptrs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data, height, width, nChannels,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads,
        int(scaled_decode))
    return out, ok.astype(bool)


def yuv420_packed_size(height: int, width: int) -> int:
    """Bytes per image of the planar 4:2:0 payload: Y[H*W] ++
    Cb[H/2*W/2] ++ Cr[H/2*W/2]. H and W must be positive and even."""
    if height <= 0 or width <= 0 or height % 2 or width % 2:
        raise ValueError(
            f"yuv420 packing needs positive even dims, got "
            f"{height}x{width}")
    return height * width + 2 * (height // 2) * (width // 2)


def decode_resize_pack_420(blobs: Sequence[bytes], height: int,
                           width: int, num_threads: int = 0,
                           scaled_decode: bool = False
                           ) -> Optional[tuple]:
    """JPEG decode → per-plane bilinear resize → packed planar YCbCr
    4:2:0 ``[N, H*W*3/2]`` uint8, in one native call. Standard 4:2:0
    sources come out of libjpeg raw: their chroma is never upsampled on
    the host. Returns ``(packed, ok_mask)``, or None without the shim's
    libjpeg."""
    if not has_jpeg():
        return None
    lib = get_lib()
    row = yuv420_packed_size(height, width)
    n = len(blobs)
    out = np.zeros((n, row), np.uint8)
    ok = np.zeros(n, np.uint8)
    if n == 0:
        return out, ok.astype(bool)
    ptrs, lens, refs = _blob_ptrs(blobs)
    rc = lib.sdl_decode_resize_pack_420_v3(
        ptrs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data, height, width,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads,
        int(scaled_decode))
    if rc != 0:
        raise ValueError(f"native 4:2:0 decode/pack failed (rc={rc})")
    return out, ok.astype(bool)


def resize_pack_batch(images: Sequence[np.ndarray], height: int,
                      width: int, nChannels: int = 3,
                      num_threads: int = 0) -> Optional[np.ndarray]:
    """Resize + channel-convert + pack HWC uint8 images into
    ``[N, H, W, C]`` uint8 in one native call (OpenMP over rows). Returns
    None without the shim; raises ValueError for a channel conversion it
    does not support."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(images)
    out = np.empty((n, height, width, nChannels), dtype=np.uint8)
    if n == 0:
        return out
    ptrs = (ctypes.c_void_p * n)()
    hs = np.empty(n, np.int32)
    ws = np.empty(n, np.int32)
    cs = np.empty(n, np.int32)
    refs = []  # keeps the source buffers alive over the call
    for i, img in enumerate(images):
        arr = np.ascontiguousarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.ndim != 3 or arr.dtype != np.uint8:
            raise ValueError(
                f"image {i}: expected HWC uint8, got shape "
                f"{arr.shape} dtype {arr.dtype}")
        refs.append(arr)
        ptrs[i] = arr.ctypes.data
        hs[i], ws[i], cs[i] = arr.shape
    rc = lib.sdl_resize_pack_batch(
        ptrs,
        hs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ws.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, out.ctypes.data, height, width, nChannels, num_threads)
    if rc != 0:
        raise ValueError(
            "native resize/pack failed: unsupported channel conversion "
            f"in batch (target {nChannels} channels)")
    return out
