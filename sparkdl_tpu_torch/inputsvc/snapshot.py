"""The corpus snapshot store: a content-addressed store of decoded
batches that takes decode out of every epoch after the first —
counterpart of ``sparkdl_tpu/inputsvc/snapshot.py``, behind
:meth:`DataFrame.snapshot <sparkdl_tpu_torch.data.frame.DataFrame.snapshot>`.

* **Content addressing** — the store key is ``blake2b(SNAPSHOT_VERSION |
  corpus fingerprint | decode-config key)``: a corpus change, a decode
  configuration change or a format version bump each lands in another
  key directory and decodes cold, so stale data is unreachable.
* **Self-validating chunks** — each partition's batch, in the numpy
  batch codec (``data/codec.py``), sits in a chunk file behind a header
  with its own blake2b digest, written to a temporary name and renamed.
  A truncated, corrupted or missing chunk fails closed on read: it is
  deleted and that partition decoded again
  (``inputsvc.snapshot_corruptions``), never served stale.
* **Versioned manifest** — ``MANIFEST.json`` pins the version,
  fingerprint, decode key, schema and partition count. One that does
  not parse or does not match is wiped with its store and rebuilt
  (``inputsvc.snapshot_invalidations``).

Counted: ``inputsvc.snapshot_hits`` / ``snapshot_misses`` /
``snapshot_writes`` / ``snapshot_bytes``. Warm reads pass the
``snapshot.read`` fault site, so the recovery path can be drilled.

The chunk format is not byte-compatible with the JAX package's (Arrow
IPC chunks, format version 1): the port's chunks are the numpy codec
under format version 1001, so neither package reads the other's store,
and a store shared between them keys each package's snapshots apart.
Chunks with object columns are pickled: share a store only between
runs of this program.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import struct
import threading
from typing import List, Optional, Sequence

from sparkdl_tpu_torch.data.codec import Batch, decode_batch, encode_parts
from sparkdl_tpu_torch.obs import default_registry
from sparkdl_tpu_torch.resilience.errors import TransientError
from sparkdl_tpu_torch.resilience.faults import maybe_fail

logger = logging.getLogger(__name__)

#: snapshot format version: part of the store key (a bump makes every
#: old snapshot unreachable, never misread) and pinned in the manifest
#: and each chunk header (so a hand-edited store fails closed). The
#: JAX package's stores are version 1 with Arrow chunks; the port's
#: chunks are the numpy batch codec, under a version of their own.
SNAPSHOT_VERSION = 1001

#: chunk-file magic
CHUNK_MAGIC = b"SNPT"

#: chunk header: magic | u16 version | u64 payload_len | blake2b-32
_CHUNK_HEADER = struct.Struct(">4sHQ32s")

MANIFEST_NAME = "MANIFEST.json"


def _count(what: str, amount: float = 1.0) -> None:
    default_registry().counter(f"inputsvc.{what}").add(amount)


class SnapshotCorruption(TransientError):
    """A chunk file failed validation (bad magic/version/digest,
    truncation). TRANSIENT by design: the reader deletes the chunk and
    re-decodes the partition — recovery is always possible because the
    snapshot is a cache, never the only copy."""


def snapshot_key(fingerprint: str, decode_key: str) -> str:
    """The content address: corpus identity x decode configuration x
    format version → one hex store key."""
    h = hashlib.blake2b(digest_size=16)
    h.update(f"v{SNAPSHOT_VERSION}|{fingerprint}|{decode_key}"
             .encode("utf-8"))
    return h.hexdigest()


def _chunk_header(payload_len: int, digest: bytes) -> bytes:
    return _CHUNK_HEADER.pack(CHUNK_MAGIC, SNAPSHOT_VERSION, payload_len,
                              digest)


def _write_chunk(path: str, batch: Batch) -> None:
    """Encode ``batch`` into the chunk file ``path``: the header, then
    the codec's parts written straight from the columns' memory."""
    parts, total = encode_parts(batch)
    h = hashlib.blake2b(digest_size=32)
    pos = 0
    for offset, body in parts:
        if offset > pos:
            h.update(bytes(offset - pos))       # the alignment padding
        h.update(body)
        pos = offset + body.nbytes
    if total > pos:
        h.update(bytes(total - pos))
    with open(path, "wb") as f:
        f.write(_chunk_header(total, h.digest()))
        pos = 0
        for offset, body in parts:
            if offset > pos:
                f.write(bytes(offset - pos))
            f.write(body)
            pos = offset + body.nbytes
        if total > pos:
            f.write(bytes(total - pos))


def _read_chunk(path: str) -> memoryview:
    """Read and validate one chunk file → its codec payload (a view of
    a ``bytearray``, so the decoded arrays are writable). Raises
    :class:`SnapshotCorruption` on any validation failure."""
    with open(path, "rb") as f:
        raw = bytearray(os.fstat(f.fileno()).st_size)
        got = f.readinto(raw)
    if got != len(raw) or len(raw) < _CHUNK_HEADER.size:
        raise SnapshotCorruption(
            f"snapshot chunk {path!r} is truncated below its header")
    magic, version, payload_len, digest = _CHUNK_HEADER.unpack(
        raw[:_CHUNK_HEADER.size])
    if magic != CHUNK_MAGIC:
        raise SnapshotCorruption(
            f"snapshot chunk {path!r} has bad magic {bytes(magic)!r}")
    if version != SNAPSHOT_VERSION:
        raise SnapshotCorruption(
            f"snapshot chunk {path!r} is format v{version}; this "
            f"process reads v{SNAPSHOT_VERSION}")
    payload = memoryview(raw)[_CHUNK_HEADER.size:]
    if len(payload) != payload_len:
        raise SnapshotCorruption(
            f"snapshot chunk {path!r} is truncated: header promises "
            f"{payload_len} payload bytes, file holds {len(payload)}")
    if hashlib.blake2b(payload, digest_size=32).digest() != digest:
        raise SnapshotCorruption(
            f"snapshot chunk {path!r} failed its digest check "
            "(corrupted on disk)")
    return payload


#: in-process lock for manifest check-then-act (the cache_to_disk
#: precedent: concurrent callers sharing a store must not race the
#: validation into spurious wipes)
_manifest_lock = threading.Lock()


def _wipe_store(directory: str) -> None:
    """Delete a store directory's contents (invalid manifest) so the
    caller rebuilds cold — the CLEAN re-decode contract: stale data
    must be unreachable the moment identity stops matching."""
    for name in os.listdir(directory):
        path = os.path.join(directory, name)
        try:
            os.remove(path)
        except OSError as e:
            logger.warning("inputsvc snapshot: could not remove "
                           "stale %r: %s", path, e)


def _ensure_manifest(directory: str, manifest: dict) -> None:
    """Validate-or-create the store manifest (caller-locked pattern
    inside): a matching manifest is a warm store; a missing one is
    cold; an unreadable or MISMATCHED one (hand-edited version field,
    foreign fingerprint — identity says this is not our store) is
    wiped and rebuilt, counted + logged, never silently read."""
    manifest_path = os.path.join(directory, MANIFEST_NAME)
    with _manifest_lock:
        if os.path.exists(manifest_path):
            existing = None
            try:
                with open(manifest_path) as f:
                    existing = json.load(f)
            except (OSError, ValueError) as e:
                logger.warning("inputsvc snapshot: manifest %r is "
                               "unreadable (%s); invalidating the "
                               "store", manifest_path, e)
            if existing == manifest:
                return
            if existing is not None:
                logger.warning(
                    "inputsvc snapshot: store %r manifest does not "
                    "match this corpus/decode-config/version; "
                    "invalidating and re-decoding cold", directory)
            _count("snapshot_invalidations")
            _wipe_store(directory)
        tmp = (f"{manifest_path}.tmp.{os.getpid()}"
               f".{threading.get_ident()}")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, sort_keys=True)
        os.replace(tmp, manifest_path)


def snapshot_sources(sources: Sequence, plan: Sequence,
                     schema: Batch, root: str, fingerprint: str,
                     decode_key: Optional[str] = None) -> List:
    """Build the snapshot-backed source list for
    :meth:`DataFrame.snapshot` (data/frame.py): each source's first
    load decodes through ``plan`` and writes a validated chunk; every
    later load — this process, the next epoch, another tenant sharing
    ``root`` — streams the chunk back with decode busy-seconds ≈ 0.
    ``decode_key`` defaults to the plan's stage-name signature; pass
    an explicit key when stage behavior changes under a stable name
    (the fingerprint discipline of ``cache_to_disk``)."""
    from sparkdl_tpu_torch.data.frame import Source, describe_schema
    plan = list(plan)
    if decode_key is None:
        decode_key = ",".join(st.name for st in plan)
    key = snapshot_key(str(fingerprint), str(decode_key))
    directory = os.path.join(root, key)
    os.makedirs(directory, exist_ok=True)
    manifest = {"version": SNAPSHOT_VERSION, "key": key,
                "fingerprint": str(fingerprint),
                "decode_key": str(decode_key),
                "schema": describe_schema(schema),
                "num_partitions": len(sources)}
    _ensure_manifest(directory, manifest)
    preserving = all(st.row_preserving for st in plan)

    def make(i: int, src) -> "Source":
        logical = (src.logical_index
                   if src.logical_index is not None else i)
        path = os.path.join(directory, f"chunk_{logical:05d}.snap")
        return Source(SnapshotLoad(src, plan, logical, path, directory),
                      src.num_rows if preserving else None,
                      logical_index=src.logical_index,
                      # the first load writes the chunk: the engine
                      # drains straggler loads on error or abandonment
                      effectful=True)

    return [make(i, s) for i, s in enumerate(sources)]


@dataclasses.dataclass(frozen=True, eq=False)
class SnapshotLoad:
    """A snapshot partition's ``load``: the chunk when it validates,
    else the partition decoded through ``plan`` and written as a chunk
    (to a temporary name, then renamed). Picklable, so a snapshot
    frame's partitions ship to the host pipeline's worker processes."""
    source: object
    plan: list
    logical: int
    path: str
    directory: str

    def __call__(self) -> Batch:
        path = self.path
        if os.path.exists(path):
            try:
                # the corrupt/missing-chunk drill's seam
                maybe_fail("snapshot.read")
                payload = _read_chunk(path)
                batch = decode_batch(payload)
                _count("snapshot_hits")
                _count("snapshot_bytes", len(payload))
                return batch
            except (OSError, TransientError, ValueError) as e:
                # failed closed: drop the bad chunk and decode again
                # below (a permanent injected fault propagates: the
                # fail-fast drill stays fail-fast)
                _count("snapshot_corruptions")
                logger.warning(
                    "inputsvc snapshot: chunk %r failed validation "
                    "(%s: %s); re-decoding the partition", path,
                    type(e).__name__, e)
                try:
                    os.remove(path)
                except OSError as rm_err:
                    logger.debug("inputsvc snapshot: removing a bad "
                                 "chunk failed: %s", rm_err)
        _count("snapshot_misses")
        from sparkdl_tpu_torch.data.frame import apply_plan
        batch = apply_plan(self.plan, self.source.load(), self.logical)
        # a temporary name per process and thread (a re-submitted
        # partition may overlap its first load), published by rename
        os.makedirs(self.directory, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        _write_chunk(tmp, batch)
        os.replace(tmp, path)
        _count("snapshot_writes")
        return batch
