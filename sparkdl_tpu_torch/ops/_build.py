"""Build the port's CUDA sources into shared libraries, and load them.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher. It is
compiled by nvcc for Hopper (``sm_90a``) at first use into
``sparkdl_tpu_torch/_build/`` — a directory git ignores — under a name
that carries a hash of every ``csrc`` file and of the flags, so an edited
source or header is rebuilt and a stale library is never loaded. The
library is loaded with ctypes; callers declare each function's argtypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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
    flags and of every file in ``csrc/`` (so any header the source may
    include is covered)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for entry in sorted(os.listdir(CSRC_DIR)):
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
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"CUDA build of {name} failed: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, out)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The named kernel library, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(library_path(name))
            _loaded[name] = lib
        return lib
