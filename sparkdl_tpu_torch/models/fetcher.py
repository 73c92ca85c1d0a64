"""Hash-verified cache of model weights — counterpart of
``sparkdl_tpu/models/fetcher.py`` for torch state dicts.

Entries are ``torch.save`` blobs (``<name>.pt``) or the JAX package's
flax blobs (``<name>.msgpack``, read by ``models/msgpack.py``), each with
a ``.sha256`` sidecar, checked on every load. The cache directory is ``$SPARKDL_TPU_TORCH_MODEL_CACHE``,
else ``~/.cache/sparkdl_tpu_torch/models``. Nothing is downloaded: a
cache is seeded with :meth:`ModelFetcher.put` (for example with weights
converted from the JAX package by ``models/convert.py``).
"""

from __future__ import annotations

import hashlib
import io
import os
from typing import Dict, Optional

import torch

CACHE_ENV = "SPARKDL_TPU_TORCH_MODEL_CACHE"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.expanduser("~"), ".cache", "sparkdl_tpu_torch", "models")


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class ModelFetcher:
    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or os.environ.get(
            CACHE_ENV, DEFAULT_CACHE_DIR)

    def _path(self, fileName: str) -> str:
        return os.path.join(self.cache_dir, fileName)

    def has(self, fileName: str) -> bool:
        return os.path.exists(self._path(fileName))

    def _commit(self, fileName: str, blob: bytes, digest: str) -> None:
        """Sidecar first, then blob, each by tmp + rename: a blob never
        exists without a sidecar, so a crash leaves at worst an orphan
        sidecar (``has`` is false) or a blob that fails its hash check
        loudly."""
        os.makedirs(self.cache_dir, exist_ok=True)
        path = self._path(fileName)
        for target, data, mode in ((path + ".sha256", digest, "w"),
                                   (path, blob, "wb")):
            tmp = f"{target}.tmp.{os.getpid()}"
            with open(tmp, mode) as f:
                f.write(data)
            os.replace(tmp, target)

    def put(self, fileName: str,
            state_dict: Dict[str, torch.Tensor]) -> str:
        """Store a state dict (moved to the CPU); returns its sha256."""
        buf = io.BytesIO()
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
                   buf)
        blob = buf.getvalue()
        digest = _sha256(blob)
        self._commit(fileName, blob, digest)
        return digest

    def get_bytes(self, fileName: str,
                  expected_sha256: Optional[str] = None) -> bytes:
        """A cache entry's bytes, verified against its hash (the explicit
        one, else the sidecar)."""
        path = self._path(fileName)
        with open(path, "rb") as f:
            blob = f.read()
        digest = _sha256(blob)
        check = expected_sha256
        sidecar = path + ".sha256"
        if check is None and os.path.exists(sidecar):
            with open(sidecar) as f:
                check = f.read().strip()
        if check is not None and digest != check:
            raise IOError(
                f"hash mismatch for {fileName}: got {digest[:12]}…, "
                f"expected {check[:12]}… — delete the cache entry and "
                "seed it again")
        return blob

    def get(self, fileName: str,
            expected_sha256: Optional[str] = None
            ) -> Dict[str, torch.Tensor]:
        """Load a cached state dict onto the CPU, verifying its hash."""
        blob = self.get_bytes(fileName, expected_sha256)
        return torch.load(io.BytesIO(blob), map_location="cpu",
                          weights_only=True)
