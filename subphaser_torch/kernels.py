"""Build and load the port's hand-written CUDA kernels and its host library.

Each CUDA source under ``csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and loaded with ctypes (no PyTorch
headers, so a build takes seconds). The LTR step's host C++
(``csrc/ltr_native.cpp``) is compiled the same way by ``g++``, with
``-march=native``, so its digest also carries the host's CPU features: a
library built on another host is never loaded. Builds happen at first use,
into ``_build/`` inside the package (git-ignored); a library's file name
carries a digest of its source, the shared headers (``csrc/*.cuh``) and
its flags, so an edited source is rebuilt and never mixed up with a stale
one. Nothing here runs at import time.

A failure of this layer (a build, a load, a launch, or a CUDA fault found
by :func:`synchronize`) raises :class:`KernelError`, so a caller that
tolerates host failures (the LTR tree step) can let it through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = {
    "bitonic_sort": os.path.join(PKG_DIR, "csrc", "bitonic_sort.cu"),
    "sort_primitives": os.path.join(PKG_DIR, "csrc", "sort_primitives.cu"),
    "radix_sort": os.path.join(PKG_DIR, "csrc", "radix_sort.cu"),
    "hmm_scan": os.path.join(PKG_DIR, "csrc", "hmm_scan.cu"),
    "tree_counts": os.path.join(PKG_DIR, "csrc", "tree_counts.cu"),
    "anchors": os.path.join(PKG_DIR, "csrc", "anchors.cu"),
    "stats": os.path.join(PKG_DIR, "csrc", "stats.cu"),
    "parallel": os.path.join(PKG_DIR, "csrc", "parallel.cu"),
    "runs": os.path.join(PKG_DIR, "csrc", "runs.cu"),
    "ltr_native": os.path.join(PKG_DIR, "csrc", "ltr_native.cpp"),
}
HOST_SOURCES = {"ltr_native"}  # g++, not nvcc
HEADERS = [os.path.join(PKG_DIR, "csrc", "launch_after.cuh")]  # included by CUDA sources
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

# -fopenmp: sp_build_cs runs its gap alignments in parallel; -march=native:
# the banded-DP rows vectorise. Toolchains without either fall back in order.
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
GXX_EXTRA = (["-march=native", "-fopenmp"], ["-fopenmp"], [])

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel or native library failed to build, load or launch, or a
    CUDA fault surfaced after a launch."""


def synchronize(device) -> None:
    """Waits for ``device`` (a CUDA device); a CUDA fault of an earlier
    launch is raised as KernelError."""
    import torch

    try:
        torch.cuda.synchronize(device)
    except RuntimeError as e:
        raise KernelError(f"CUDA error after a kernel launch: {e}") from e


def _host_isa_tag() -> str:
    """Fingerprint of this host's ISA (a -march=native library carried to a
    host with a narrower ISA loads but dies on its first call)."""
    import platform

    feats = platform.platform()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return platform.machine() + "|" + feats


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> str:
    with open(SOURCES[name], "rb") as f:
        key = f.read()
    if name in HOST_SOURCES:
        key += (" ".join(GXX_FLAGS) + repr(GXX_EXTRA) + _host_isa_tag()).encode()
    else:
        key += " ".join(NVCC_FLAGS).encode()
        for header in HEADERS:
            with open(header, "rb") as f:
                key += f.read()
    digest = hashlib.sha256(key).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def _command(name: str, tmp: str, verbose: bool, extra=()) -> list[str]:
    if name in HOST_SOURCES:
        return ["g++", *GXX_FLAGS, *extra, "-o", tmp, SOURCES[name]]
    return [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
            "-o", tmp, SOURCES[name]]


def build(names=None, force: bool = False, verbose: bool = False) -> dict[str, float]:
    """Compile the named libraries (all by default), one compiler each, all
    started together. Returns {name: seconds} for the ones compiled;
    raises KernelError with the compiler's output when a build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out) and not force:
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        extra = GXX_EXTRA[0] if name in HOST_SOURCES else ()
        procs[name] = (subprocess.Popen(_command(name, tmp, verbose, extra),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds = {}
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0 and name in HOST_SOURCES:
            for extra in GXX_EXTRA[1:]:
                res = subprocess.run(_command(name, tmp, verbose, extra),
                                     capture_output=True, text=True)
                if res.returncode == 0:
                    proc, log = res, res.stdout + res.stderr
                    break
        seconds[name] = time.perf_counter() - t0
        if verbose and log:
            print(log.rstrip())
        if proc.returncode != 0:
            failed.append(f"{name}: compiler exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library ``name``, built first if needed (thread-safe)."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            _loaded[name] = lib
    return lib


def graph_kernel_launches(fn) -> int:
    """The kernels one call of ``fn()`` launches: the call captured into a
    CUDA graph (torch.cuda.CUDAGraph, after a warm-up call outside it), and
    the graph's kernel nodes counted through the driver (cuGraphGetNodes,
    cuGraphNodeGetType). A capture sees every launch on the stream, where
    torch.profiler late in a long process may record none."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)  # the graph stays readable after capture
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if count.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    del graph
    torch.cuda.synchronize()
    return kernels
