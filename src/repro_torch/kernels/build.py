"""Build and load the port's CUDA kernels.

The ``.cu`` sources under ``kernels/csrc`` have a plain C interface and
share the device helpers of ``mma_split.cuh``. At first use each is
compiled with ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and the objects are linked into one shared
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    for src in sorted(_CSRC.glob("*.cu*")):     # the headers too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libplcore_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the library for their hash is missing: one
    ``nvcc -c`` per source, all running at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = [], []
    for src, proc in zip(sources(), procs):
        stdout, stderr = proc.communicate()
        logs.append(stderr)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, out)
    for obj in objs:
        obj.unlink()
    BUILD_LOG["seconds"] = time.perf_counter() - t0
    BUILD_LOG["ptxas"] = "".join(logs)
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
        lib.plcore_blocks_per_sm.argtypes = [vp, ci, vp]
        lib.plcore_blocks_per_sm.restype = ci
        lib.plcore_mip_two_pass.argtypes = [vp, vp, vp]
        lib.plcore_mip_two_pass.restype = ci
        lib.plcore_mip_blocks_per_sm.argtypes = [vp, vp]
        lib.plcore_mip_blocks_per_sm.restype = ci
        lib.rmcm_matmul_plan.argtypes = [ci, ci, ci, ci, vp]
        lib.rmcm_matmul_plan.restype = ci
        lib.rmcm_matmul.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                    vp, vp]
        lib.rmcm_matmul.restype = ci
        _LIB = lib
    return _LIB
