"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on first use into its own shared library
with a plain C interface, under ``build/cuda/`` at the repository root (a
git-ignored directory). The library's name carries a hash of the source and
the flags, so an edit to either builds anew. Nothing here runs on import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "cuda")
# -fmad=false and no --use_fast_math: float arithmetic rounds as the plain
# torch versions round it
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict = {}
BUILD_LOG: dict = {}  # name -> (seconds, nvcc output) of each build in this process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(names=None) -> None:
    """Compile the named sources (default: every ``csrc/*.cu``) that have no
    library yet, one nvcc process each, all started together."""
    if names is None:
        names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC, "*.cu")))
    todo = [(n, _lib_path(n)) for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name, so in todo:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
        BUILD_LOG[name] = (time.perf_counter() - t0, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, compiled if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return _LIBS[name]
