"""Build and load the port's CUDA kernels.

The ``.cu`` sources under ``kernels/csrc`` have a plain C interface. At
first use they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library under ``build/kernels/`` at the repository root (a directory that
``.gitignore`` lists), named by the hash of the sources and flags, so a
changed source rebuilds and an unchanged one is reused. The library is
loaded with ``ctypes``; every pointer and the stream cross as
``c_void_p``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB = None
BUILD_LOG = {"seconds": None, "ptxas": ""}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources():
    return sorted(_CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libplcore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the library for their hash is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           *map(str, sources())],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["ptxas"] = proc.stderr
    return out


def load():
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.plcore_fused.argtypes = [vp, vp, vp]
        lib.plcore_fused.restype = ci
        lib.plcore_two_pass.argtypes = [vp, vp, ctypes.c_float, vp]
        lib.plcore_two_pass.restype = ci
        _LIB = lib
    return _LIB
