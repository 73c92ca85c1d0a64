"""Reader of flax's serialized variables — the port's counterpart of
``flax.serialization.msgpack_restore`` (``from_bytes`` without the
template), written by hand because the port imports no msgpack.

A blob is a msgpack map of maps (``{"params": {...}, "batch_stats":
{...}}``) whose leaves are arrays in msgpack's extension type 1: the
payload is itself a msgpack array ``(shape, dtype name, raw bytes)``,
row-major. (flax splits an array above 1 GiB into chunks; no zoo model
has one — VGG's largest, ``Dense_0``, is 411 MB — and the reader
refuses the chunked form's booleans.)

Each leaf is an ``np.frombuffer`` view of the blob, so reading copies no
array bytes; the views keep the blob alive. Read-only: convert with
``models/convert.py``, which makes the one copy.

The reader takes what flax writes for variables: maps, arrays, str,
bin, unsigned ints (the shapes), and the extension types ext 8/16/32
(ext32 above 64 KiB) and fixext. Any other type byte, an extension other
than an array, an unknown dtype or a truncated blob raises
``ValueError`` naming the offset.
"""

from __future__ import annotations

from typing import Any

import numpy as np

_EXT_NDARRAY = 1

# unsigned ints: type byte → size
_UINT = {0xcc: 1, 0xcd: 2, 0xce: 4, 0xcf: 8}
# length-prefixed items: type byte → (kind, bytes of the length)
_SIZED = {
    0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
    0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
    0xdc: ("array", 2), 0xdd: ("array", 4),
    0xde: ("map", 2), 0xdf: ("map", 4),
    0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
}
# fixext 1/2/4/8/16: type byte → payload size
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int, at: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(
                f"msgpack: item at offset {at} needs {n} bytes from offset "
                f"{self.pos}, the blob ends at {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def uint(self, size: int, at: int) -> int:
        return int.from_bytes(self.take(size, at), "big")

    def read(self) -> Any:
        at = self.pos
        b = self.take(1, at)[0]
        if b <= 0x7f:
            return b
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f, at)
        if 0x90 <= b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.text(b & 0x1f, at)
        if b in _UINT:
            return self.uint(_UINT[b], at)
        if b in _FIXEXT:
            code = self.take(1, at)[0]
            return self.ext(code, _FIXEXT[b], at)
        if b in _SIZED:
            kind, size = _SIZED[b]
            n = self.uint(size, at)
            if kind == "str":
                return self.text(n, at)
            if kind == "bin":
                return self.take(n, at)
            if kind == "array":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self.map(n, at)
            code = self.take(1, at)[0]
            return self.ext(code, n, at)
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x} at "
                         f"offset {at}")

    def text(self, n: int, at: int) -> str:
        return str(self.take(n, at), "utf-8")

    def map(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, code: int, n: int, at: int) -> np.ndarray:
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack: unsupported extension type {code} "
                             f"at offset {at}")
        start = self.pos
        payload = self.take(n, at)
        inner = _Reader(payload)
        try:
            shape, dtype_name, raw = inner.read()
            dtype = np.dtype(dtype_name)
        except (TypeError, ValueError) as e:
            raise ValueError(f"msgpack: array at offset {at} is not "
                             f"(shape, dtype, bytes): {e}") from e
        if inner.pos != n or not isinstance(raw, memoryview) \
                or not isinstance(shape, list):
            raise ValueError(f"msgpack: array at offset {at} is not "
                             f"(shape, dtype, bytes) in {n} bytes from "
                             f"offset {start}")
        count = int(np.prod(shape, dtype=np.int64))
        if count * dtype.itemsize != len(raw):
            raise ValueError(
                f"msgpack: array at offset {at} of shape {shape} "
                f"{dtype_name} holds {len(raw)} bytes")
        return np.frombuffer(raw, dtype=dtype, count=count).reshape(shape)


def loads(blob) -> Any:
    """Decode one msgpack object (the whole blob) into dicts, lists,
    scalars and read-only ``np.ndarray`` views of ``blob``."""
    reader = _Reader(memoryview(blob).cast("B"))
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         f"left over after the object, from offset "
                         f"{reader.pos}")
    return out
