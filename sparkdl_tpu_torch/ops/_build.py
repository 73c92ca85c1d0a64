"""Build the port's CUDA sources into shared libraries, and load them.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled by nvcc for Hopper (``sm_90a``) at first use into
``sparkdl_tpu_torch/_build/`` — a directory git ignores — under a name
that carries a hash of its source, of the headers beside it and of the
flags, so an edited source or header is rebuilt and a stale library is
never loaded. The library is loaded with ctypes; callers declare each
function's argtypes.
A build that really ran nvcc is a ``build`` event in the compile log
(``obs/compile_log.py``) when it is armed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from PATH, else under ``$CUDA_HOME`` or the toolkit's
    standard install prefix; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's CUDA kernels "
        "are built from source at first use")


def library_path(name: str) -> str:
    """Where the library of ``name`` goes: its name carries a hash of the
    flags, of ``csrc/<name>.cu`` and of every other file in ``csrc/`` that
    is not a ``.cu`` source (so any header the source may include is
    covered, and another kernel's source is not: each kernel is a library
    of its own, rebuilt only when its own inputs change)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for entry in sorted(os.listdir(CSRC_DIR)):
        if entry.endswith(".cu") and entry != f"{name}.cu":
            continue
        with open(os.path.join(CSRC_DIR, entry), "rb") as f:
            digest.update(entry.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(name: str, ptxas_report: bool = False) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns
    nvcc's output ("" when nothing was built); with ``ptxas_report`` it
    holds ptxas's register and spill report. Raises with nvcc's output
    if the compile fails."""
    out = library_path(name)
    if os.path.exists(out):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    # -Xptxas=-v changes only what nvcc prints, not the library
    cmd = [find_nvcc(), *NVCC_FLAGS, *(["-Xptxas=-v"] if ptxas_report
                                       else []),
           "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {name} failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    from sparkdl_tpu_torch.obs.compile_log import record_build
    record_build(f"kernel.{name}", time.perf_counter() - t0,
                 {"library": os.path.basename(out), "compiler": "nvcc"})
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            # sparkdl-lint: allow[H8] -- one-shot nvcc build under the load lock is the point: every caller must wait for (and share) THE kernel library; a second unlocked build would race the .so write (the native shim's precedent)
            build(name)
            # sparkdl-lint: allow[H8] -- the library path is keyed by the source hash the build just wrote, read under the same load lock
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib
