"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ctypes (no PyTorch headers, so a
build takes seconds). Builds happen at first use, into ``_build/`` inside
the package (git-ignored); a library's file name carries a digest of its
source and flags, so an edited source is rebuilt and never mixed up with a
stale one. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = {
    "bitonic_sort": os.path.join(PKG_DIR, "csrc", "bitonic_sort.cu"),
    "sort_primitives": os.path.join(PKG_DIR, "csrc", "sort_primitives.cu"),
    "radix_sort": os.path.join(PKG_DIR, "csrc", "radix_sort.cu"),
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build(names=None, force: bool = False, verbose: bool = False) -> dict[str, float]:
    """Compile the named kernels (all by default), one nvcc each, all
    started together. Returns {name: seconds} for the ones compiled;
    raises RuntimeError with nvcc's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out) and not force:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, SOURCES[name]]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if verbose and log:
            print(log.rstrip())
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        _loaded[name] = lib
    return lib
