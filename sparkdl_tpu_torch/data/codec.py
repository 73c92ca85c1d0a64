"""The numpy batch codec: one byte layout for a batch (dict of column →
ndarray) wherever one crosses a process boundary — the host pipeline's
shared-memory and pipe hand-off (``data/pipeline.py``), the decode
fleet's socket payload (``inputsvc/``) and the snapshot store's chunks
(``inputsvc/snapshot.py``). It takes the place of the JAX package's
Arrow IPC stream; the port has no pyarrow.

Layout (integers big-endian)::

    MAGIC (4) | header_len (u32) | header JSON | pad | buffers

The header names each column in order with its kind (``"raw"`` or
``"pickle"``), ``dtype.str``, shape, and the offset and length of its
buffer from the start of the message. Every buffer starts on a
:data:`ALIGN`-byte boundary. A numeric, boolean, fixed-width string or
datetime column is its array's raw C-order bytes; any other column
(object arrays: paths, image structs; structured dtypes) is its array
pickled with the standard library. Decoding makes each raw column an
``np.frombuffer`` view over the one buffer it was given, so there is no
copy per column; the arrays are writable when that buffer is (a
``bytearray``). Zero-row batches keep their columns, dtypes and row
shapes.

Pickled columns run code when loaded: decode only bytes that this
program or its own workers wrote.
"""

from __future__ import annotations

import json
import pickle
import struct
from typing import Dict, List, Tuple

import numpy as np

Batch = Dict[str, np.ndarray]

MAGIC = b"SDNB"
_PREFIX = struct.Struct(">4sI")
#: buffer alignment: every column's bytes start on a multiple of this
ALIGN = 64
#: dtype kinds stored as raw bytes; anything else is pickled
_RAW_KINDS = "biufcSUmM"


class CodecError(ValueError):
    """Bytes that are not a batch this codec wrote (bad magic, a header
    that does not parse, a buffer outside the message)."""


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def _is_raw(arr: np.ndarray) -> bool:
    return arr.dtype.kind in _RAW_KINDS and arr.dtype.fields is None


def encode_parts(batch: Batch) -> Tuple[List[Tuple[int, memoryview]], int]:
    """The encoded message as ``(offset, bytes)`` parts and its total
    size, without joining them: a caller that owns the destination (a
    shared-memory segment) copies each part once, straight from the
    column's own memory."""
    columns = []
    bodies = []
    for name, col in batch.items():
        arr = np.asarray(col)
        if _is_raw(arr):
            arr = np.ascontiguousarray(arr)
            body = memoryview(arr.reshape(-1).view(np.uint8))
            kind = "raw"
        else:
            body = memoryview(pickle.dumps(arr, pickle.HIGHEST_PROTOCOL))
            kind = "pickle"
        columns.append([str(name), kind, arr.dtype.str, list(arr.shape)])
        bodies.append(body)
    # two passes: the header's own length decides where the data starts
    header = {"columns": columns}
    data_start = 0
    while True:
        offsets, pos = [], data_start
        for body in bodies:
            offsets.append(pos)
            pos = _align(pos + body.nbytes)
        header["buffers"] = [[o, b.nbytes] for o, b in zip(offsets, bodies)]
        raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
        need = _align(_PREFIX.size + len(raw))
        if need == data_start:
            break
        data_start = need
    total = max(data_start, offsets[-1] + bodies[-1].nbytes) if bodies \
        else data_start
    parts = [(0, memoryview(_PREFIX.pack(MAGIC, len(raw)) + raw))]
    parts += [(o, b) for o, b in zip(offsets, bodies) if b.nbytes]
    return parts, total


def write_parts(parts, dest: memoryview) -> None:
    """Copy encoded parts into ``dest`` (a writable byte view at least
    as long as the message)."""
    for offset, body in parts:
        dest[offset:offset + body.nbytes] = body


def encode_batch(batch: Batch) -> bytearray:
    """One batch → its encoded message."""
    parts, total = encode_parts(batch)
    out = bytearray(total)
    write_parts(parts, memoryview(out))
    return out


def decode_batch(data) -> Batch:
    """An encoded message → the batch. Raw columns are views over
    ``data`` (which they keep alive); pickled columns are loaded."""
    mv = memoryview(data)
    if mv.format != "B" or mv.ndim != 1:
        mv = mv.cast("B")
    if mv.nbytes < _PREFIX.size:
        raise CodecError(f"a {mv.nbytes}-byte message is shorter than "
                         "the codec's prefix")
    magic, hdr_len = _PREFIX.unpack(mv[:_PREFIX.size])
    if magic != MAGIC:
        raise CodecError(f"bad batch magic {bytes(magic)!r}")
    try:
        header = json.loads(bytes(mv[_PREFIX.size:_PREFIX.size + hdr_len]))
        columns, buffers = header["columns"], header["buffers"]
    except (ValueError, KeyError, TypeError) as e:
        raise CodecError(f"batch header does not parse: {e}") from e
    out: Batch = {}
    for (name, kind, dtype, shape), (offset, nbytes) in zip(columns,
                                                             buffers):
        if offset < 0 or offset + nbytes > mv.nbytes:
            raise CodecError(f"column {name!r}: buffer [{offset}, "
                             f"{offset + nbytes}) lies outside a "
                             f"{mv.nbytes}-byte message")
        if kind == "pickle":
            arr = pickle.loads(mv[offset:offset + nbytes])
        else:
            dt = np.dtype(dtype)
            count = int(np.prod(shape, dtype=np.int64))
            if count * dt.itemsize != nbytes:
                raise CodecError(f"column {name!r}: {nbytes} bytes for "
                                 f"shape {shape} of {dtype}")
            arr = (np.frombuffer(mv, dt, count, offset).reshape(shape)
                   if count else np.empty(shape, dt))
        out[name] = arr
    return out
