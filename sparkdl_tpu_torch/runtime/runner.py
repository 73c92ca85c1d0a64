"""BatchRunner: run a ModelFunction over host arrays in fixed-size
device chunks — counterpart of ``sparkdl_tpu/runtime/runner.py``
(``RunnerMetrics``, ``BatchRunner.run``; the JAX runner's strategies and
infeed ring wait for a later slice).

Per chunk of ``batch_size`` rows: the rows are written into one pinned
host staging buffer per input (the tail zero-padded, so the model always
sees one batch shape), copied to the device with ``non_blocking=True``,
run, and the valid rows of each output are copied back into one
preallocated ``[N, *out]`` host slab. That copy back waits for the
chunk's work, which also makes it safe to rewrite the staging buffer
for the next chunk.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from sparkdl_tpu_torch.graph.function import ModelFunction


@dataclass
class RunnerMetrics:
    """Throughput and host-copy counters (the JAX runner's field names).

    ``bytes_staged``: input bytes written through the pinned staging
    buffers (every chunk here). ``bytes_copied``: input bytes of rows
    that were not contiguous in the caller's array. ``transfer_wait_
    seconds``: time blocked copying outputs back to the host, which
    includes waiting for the device to finish the chunk."""

    rows: int = 0
    batches: int = 0
    seconds: float = 0.0
    bytes_staged: int = 0
    bytes_copied: int = 0
    transfer_wait_seconds: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def add(self, rows: int, batches: int, seconds: float,
            bytes_staged: int = 0, bytes_copied: int = 0,
            transfer_wait_seconds: float = 0.0):
        with self._lock:
            self.rows += rows
            self.batches += batches
            self.seconds += seconds
            self.bytes_staged += bytes_staged
            self.bytes_copied += bytes_copied
            self.transfer_wait_seconds += transfer_wait_seconds


def check_row_counts(inputs: Dict[str, np.ndarray]) -> int:
    """Validate equal leading dims across named inputs; returns N."""
    names = list(inputs)
    if not names:
        raise ValueError("no inputs")
    n = len(inputs[names[0]])
    for k, v in inputs.items():
        if len(v) != n:
            raise ValueError(f"input {k!r} has {len(v)} rows, expected {n}")
    return n


def check_against_signature(inputs: Dict[str, np.ndarray],
                            model_fn: ModelFunction) -> None:
    """Every declared model input must be present with the declared
    per-row shape and dtype."""
    missing = [k for k in model_fn.input_signature if k not in inputs]
    if missing:
        raise ValueError(
            f"model {model_fn.name!r} inputs {missing} missing from "
            f"runner inputs {sorted(inputs)}")
    for k, (shape, dtype) in model_fn.input_signature.items():
        got = tuple(np.shape(inputs[k])[1:])
        if got != tuple(shape):
            raise ValueError(
                f"input {k!r} rows have shape {got}; model "
                f"{model_fn.name!r} expects {tuple(shape)}")
        if np.asarray(inputs[k]).dtype != np.dtype(dtype):
            raise ValueError(
                f"input {k!r} has dtype {np.asarray(inputs[k]).dtype}; "
                f"model {model_fn.name!r} expects {np.dtype(dtype)}")


class BatchRunner:
    """Runs a ModelFunction over host arrays in fixed-size device chunks."""

    def __init__(self, model_fn: ModelFunction, batch_size: int = 64,
                 metrics: Optional[RunnerMetrics] = None):
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.model_fn = model_fn
        self.batch_size = batch_size
        self.metrics = metrics or RunnerMetrics()
        self._staging: Dict[str, torch.Tensor] = {}
        # one run at a time: the staging buffers are shared
        self._lock = threading.Lock()

    @property
    def preferred_chunk(self) -> int:
        """Row count at which run() pads nothing: the device batch."""
        return self.batch_size

    def _stage_buffer(self, name: str, rows: np.ndarray) -> torch.Tensor:
        shape = (self.batch_size,) + rows.shape[1:]
        dtype = torch.from_numpy(np.empty(0, rows.dtype)).dtype
        buf = self._staging.get(name)
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype,
                              pin_memory=self.model_fn.device.type == "cuda")
            self._staging[name] = buf
        return buf

    def run(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """inputs: {name: [N, *row_shape]} → {name: [N, *out_shape]}."""
        n = check_row_counts(inputs)
        if n == 0:
            # before the signature check: an empty column may arrive flat
            return self._empty_outputs()
        check_against_signature(inputs, self.model_fn)
        with self._lock:
            return self._run(inputs, n)

    def _run(self, inputs: Dict[str, np.ndarray], n: int
             ) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        mf, bs = self.model_fn, self.batch_size
        names = mf.input_names
        staged = copied = 0
        wait = 0.0
        slabs: Optional[Dict[str, torch.Tensor]] = None
        for lo in range(0, n, bs):
            valid = min(bs, n - lo)
            dev = {}
            for k in names:
                rows = np.asarray(inputs[k])[lo:lo + valid]
                buf = self._stage_buffer(k, rows)
                host = buf.numpy()
                host[:valid] = rows
                host[valid:] = 0
                staged += rows.nbytes
                if not rows.flags.c_contiguous:
                    copied += rows.nbytes
                dev[k] = buf.to(mf.device, non_blocking=True)
            out = mf.apply(dev)
            if slabs is None:
                slabs = {k: torch.empty((n,) + tuple(out[k].shape[1:]),
                                        dtype=out[k].dtype)
                         for k in mf.output_names}
            t1 = time.perf_counter()
            for k in mf.output_names:
                slabs[k][lo:lo + valid].copy_(out[k][:valid])
            wait += time.perf_counter() - t1
        batches = -(-n // bs)
        self.metrics.add(n, batches, time.perf_counter() - t0,
                         bytes_staged=staged, bytes_copied=copied,
                         transfer_wait_seconds=wait)
        assert slabs is not None
        return {k: v.numpy() for k, v in slabs.items()}

    def _empty_outputs(self) -> Dict[str, np.ndarray]:
        """Zero-row outputs with the per-row shapes of a one-row probe."""
        probe = {k: np.zeros((1,) + tuple(shape), dtype)
                 for k, (shape, dtype)
                 in self.model_fn.input_signature.items()}
        out = self.model_fn(probe)
        return {k: v[:0] for k, v in out.items()}
