"""Length-prefixed socket framing for the decode fleet — counterpart of
``sparkdl_tpu/inputsvc/transport.py``, with the same wire layout and
bounds and a wire version of its own.

One message is a fixed binary prefix, a small JSON header and an opaque
payload (all integers big-endian)::

    MAGIC (4)  | WIRE_VERSION (u16) | header_len (u32) | payload_len (u64)
    header JSON (header_len bytes)  | payload (payload_len bytes)

The header is a JSON object (op, token, index, flags — never bulk
data); the payload carries the bulk bytes: the pickled plan and source
on a request, the fragment in the numpy batch codec
(``data/codec.py``) on a reply. Sizes are bounded
(:data:`MAX_HEADER_BYTES`, :data:`MAX_PAYLOAD_BYTES`) so a corrupt or
hostile peer cannot make the receiver allocate unbounded memory.

Every framing failure — short read, bad magic, oversized length,
version mismatch — raises :class:`TransportError`, a typed transient:
the client re-runs the partition through the engine's retry policy and
fails over to local decode past it.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional, Tuple

from sparkdl_tpu_torch.resilience.errors import TransientError

#: frame magic — a reader that sees anything else is not talking to a
#: DecodeServer (or lost sync mid-stream) and must drop the connection
MAGIC = b"SDLT"

#: wire schema version: bumped on any frame/header change so an old
#: client and a new server fail the handshake typed instead of
#: misparsing each other's bytes. The JAX package speaks version 1 with
#: cloudpickle and Arrow payloads; the port's payloads are pickle and
#: the numpy batch codec, so it speaks a version of its own and the two
#: refuse each other.
WIRE_VERSION = 1001

#: the fixed prefix: magic + version + header_len + payload_len
_PREFIX = struct.Struct(">4sHIQ")

#: headers are small JSON control dicts; 1 MiB of header is corruption
MAX_HEADER_BYTES = 1 << 20

#: payload ceiling (1 GiB) — far above any sane decoded fragment, low
#: enough that a garbage length field cannot OOM the receiver
MAX_PAYLOAD_BYTES = 1 << 30


class TransportError(TransientError):
    """A framing/socket failure on the input-service wire (short read,
    bad magic, oversized frame, version mismatch). TRANSIENT: the
    client re-runs the partition through the shared RetryPolicy, and
    past the retry budget fails over to local decode — never a lost or
    duplicated row."""


def send_msg(sock: socket.socket, header: dict, payload=b"") -> None:
    """Send one framed message. ``header`` must be JSON-serializable;
    ``payload`` is opaque bytes (``b""`` for control messages)."""
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    if len(hdr) > MAX_HEADER_BYTES:
        raise TransportError(
            f"header of {len(hdr)} bytes exceeds the "
            f"{MAX_HEADER_BYTES}-byte bound")
    if len(payload) > MAX_PAYLOAD_BYTES:
        raise TransportError(
            f"payload of {len(payload)} bytes exceeds the "
            f"{MAX_PAYLOAD_BYTES}-byte bound")
    try:
        sock.sendall(_PREFIX.pack(MAGIC, WIRE_VERSION, len(hdr),
                                  len(payload)))
        sock.sendall(hdr)
        if payload:
            sock.sendall(payload)
    except OSError as e:
        raise TransportError(
            f"input-service send failed: {e}") from e


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    """Read exactly ``n`` bytes into a buffer of their own (writable,
    so arrays decoded over it are too) or raise :class:`TransportError`
    — a peer that hangs up mid-frame must surface as a typed transient,
    never a silently short message."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        try:
            k = sock.recv_into(view[got:], min(n - got, 1 << 20))
        except OSError as e:
            raise TransportError(
                f"input-service recv failed: {e}") from e
        if not k:
            raise TransportError(
                f"peer closed the connection {n - got} bytes short "
                f"of a {n}-byte read")
        got += k
    return buf


def recv_msg(sock: socket.socket) -> Tuple[dict, bytearray]:
    """Receive one framed message → ``(header, payload)``. Raises
    :class:`TransportError` on any framing violation."""
    prefix = _recv_exact(sock, _PREFIX.size)
    magic, version, hdr_len, payload_len = _PREFIX.unpack(prefix)
    if magic != MAGIC:
        raise TransportError(
            f"bad frame magic {magic!r} (expected {MAGIC!r}) — the "
            "peer is not a DecodeServer or the stream lost sync")
    if version != WIRE_VERSION:
        raise TransportError(
            f"wire version mismatch: peer speaks v{version}, this "
            f"process speaks v{WIRE_VERSION}")
    if hdr_len > MAX_HEADER_BYTES:
        raise TransportError(
            f"header length {hdr_len} exceeds the "
            f"{MAX_HEADER_BYTES}-byte bound")
    if payload_len > MAX_PAYLOAD_BYTES:
        raise TransportError(
            f"payload length {payload_len} exceeds the "
            f"{MAX_PAYLOAD_BYTES}-byte bound")
    try:
        header = json.loads(_recv_exact(sock, hdr_len))
    except ValueError as e:
        raise TransportError(
            f"frame header is not valid JSON: {e}") from e
    if not isinstance(header, dict):
        raise TransportError(
            f"frame header must be a JSON object, got "
            f"{type(header).__name__}")
    payload = _recv_exact(sock, payload_len) if payload_len \
        else bytearray()
    return header, payload


def parse_endpoint(raw: str) -> Optional[Tuple[str, int]]:
    """``"host:port"`` → ``(host, port)``, or None when malformed (the
    caller owns the degrade accounting — config parsing must never
    raise out of an env read)."""
    raw = raw.strip()
    host, sep, port = raw.rpartition(":")
    if not sep or not host:
        return None
    try:
        port_i = int(port)
    except ValueError:
        return None
    if not 0 < port_i < 65536:
        return None
    return host, port_i
