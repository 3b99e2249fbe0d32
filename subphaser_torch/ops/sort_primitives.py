"""Compare-exchange primitives of the bitonic sort: CUDA kernels and their
plain PyTorch versions.

Counterparts of the four Pallas kernels the JAX package keeps beside its
VMEM sort, each computing its TPU kernel's function on a flat int32 array
of whole 2^18-key blocks (the TPU's VMEM block, (2048, 128)):

- K3 ``_block_sort_kernel`` (ops/sort_vmem.py) -> :func:`block_sort_unrolled`:
  bitonic phases 1..18 of every 2^18-key block, the direction of a pair from
  bit p of its global index (ascending throughout when the array is one
  block). One launch of ``cluster_stages`` (``csrc/sort_primitives.cu``):
  a thread-block cluster of 8 CTAs holds a block on chip, 2^15 keys a CTA,
  and runs all 171 stages there. Its plain version is
  ``sort_smem.block_sort_plain(x, 18)``.
- K4 ``pallas_block_map(body)`` (tools/bench_sort_primitives.py), one body
  per candidate -> :func:`block_map`, same candidate names. The six lists
  of stages run on ``cluster_stages`` too, one launch a call.
- K5 ``_descent_masked`` -> :func:`descent_masked`.
- K6 ``_descent_grid2d`` -> :func:`descent_grid2d`. Neither pairs keys of
  two tiles (K5: 512-key groups, one direction each; K6: 2^11-key tiles of
  index bits 0..6, 10, 12, 14, 16), so each is one launch of
  ``warp_stages``: one warp a tile, its keys in registers, every stage a
  register compare-exchange or a warp shuffle.

A CPU tensor takes the plain version; a CUDA tensor launches
``csrc/sort_primitives.cu`` or raises. ``launches[name]`` counts the calls
that launched a kernel. The cluster kernel needs thread-block clusters
(sm_90a); a card on which no cluster of its shape fits makes the wrapper
raise (:func:`clusters_that_fit`).

Where a stage's partner lives on the card (the analogue of the TPU's
lane-roll / sublane-reshape / sublane-roll lowerings). In the cluster
kernel, by stride 2^b: b 0..14 in the thread's own registers, in one of
three layouts that hold bits 0..4, 5..9 or 10..14 in registers (a change
of layout is one round trip through shared memory: inside each warp
between the first two, across the CTA's warps to or from the third), b
15..17 in another CTA of the cluster (a run of such stages is one gather
from the CTAs it spans and one scatter back, through distributed shared
memory). In ``warp_stages`` (K5, K6): b 0..1 and the tile's slot bits
(K5 7..8, K6 10, 12, 14, 16) the lane's own registers, b 2..6 a warp
shuffle. So the candidates exercise:

==========================  ===========================================
candidate                   stages by where the partner lives (changes
                            of layout across / inside warps; cross-CTA
                            runs)
==========================  ===========================================
passthrough                 device memory -> registers -> device memory
elementwise30               registers only (30 dependent max(x, x - 1))
lane_roll_stages            18 register (0 / 6)
sublane_reshape_small       18 register (none)
sublane_reshape_vreg        12 register (1 / 0), 6 cross-CTA in 2 runs
sublane_roll_stages         15 register (2 / 0), 3 cross-CTA in 1 run
transpose8                  shared memory (8 transposes of 128 x 128 tiles)
descent18                   3 cross-CTA in 1 run, 15 register (1 / 2)
descent18_masked (K5)       one warp a 512-key group: 5 shuffle,
                            4 register, one launch
descent18_grid2d (K6)       one warp a strided 2^11-key tile: 4 x (6
                            shuffle + 12 register), one launch
block_sort_unrolled (K3)    165 register (13 / 20), 6 cross-CTA in 3 runs
==========================  ===========================================
"""

from __future__ import annotations

import ctypes
import functools

import torch

from subphaser_torch.ops.sort_smem import (
    _check_tensor,
    _checked_bits,
    _stage,
    block_sort_plain,
)

BLOCK_BITS = 18          # the TPU kernels' block: (2048, 128) int32
BLOCK = 1 << BLOCK_BITS
CTA_BITS = 15            # cluster kernel: keys of a CTA (a cluster holds a block)
N_STAGES = 18            # stages per candidate (one full descent's depth)
_ASCENDING = 62          # _stage's phase whose direction bit is never set

# K4: stride bits of the candidates that are lists of ascending stages
STAGE_BITS = {
    "passthrough": [],
    "lane_roll_stages": [i % 7 for i in range(N_STAGES)],
    "sublane_reshape_vreg": [10 + i % 8 for i in range(N_STAGES)],
    "sublane_reshape_small": [7 + i % 3 for i in range(N_STAGES)],
    "sublane_roll_stages": [7 + i % 11 for i in range(N_STAGES)],
    "descent18": list(range(BLOCK_BITS - 1, -1, -1)),
}
BLOCK_MAP_CANDIDATES = [
    "passthrough", "elementwise30", "lane_roll_stages", "sublane_reshape_vreg",
    "sublane_reshape_small", "sublane_roll_stages", "transpose8", "descent18",
]
ELEMENTWISE_ITERS = 30
TRANSPOSE_REPS = 8
MASKED_P = 9             # K5: stages below 2^9 run, direction = index bit 9
MASKED_BITS = list(range(MASKED_P - 1, -1, -1))
GRID2D_REVISITS = 4      # K6
GRID2D_BITS = [i % 7 if i % 2 else 10 + i % 8 for i in range(N_STAGES)]

launches = {"block_sort_unrolled": 0, "block_map": 0, "descent_masked": 0,
            "descent_grid2d": 0}
# the same launches by the library's entry point (sp_block_sort_cluster,
# sp_run_stages_cluster, sp_descent_masked_warp, ...)
entry_launches: dict[str, int] = {}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _stages_plain(x: torch.Tensor, bits, p: int = _ASCENDING) -> torch.Tensor:
    y = x.reshape(-1).clone()
    for sb in bits:
        y = _stage(y, sb, p)
    return y


def _max_dec(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, x - 1)  # x - 1 wraps at int32 min


def block_map_plain(name: str, x: torch.Tensor) -> torch.Tensor:
    """Candidate ``name`` of K4 in plain PyTorch."""
    if name in STAGE_BITS:
        return _stages_plain(x, STAGE_BITS[name])
    if name == "elementwise30":
        y = x.reshape(-1)
        for _ in range(ELEMENTWISE_ITERS):
            y = _max_dec(y)
        return y
    if name == "transpose8":
        y = x.reshape(-1, 128, 128)
        for _ in range(TRANSPOSE_REPS):
            y = _max_dec(y.transpose(1, 2))
        return y.reshape(-1)
    raise ValueError(f"unknown block_map candidate {name!r}")


def descent_masked_plain(x: torch.Tensor) -> torch.Tensor:
    """K5: of the strides 2^17..1 only those below 2^9 run; a pair sorts
    descending where bit 9 of its index is set."""
    return _stages_plain(x, MASKED_BITS, MASKED_P)


def descent_grid2d_plain(x: torch.Tensor) -> torch.Tensor:
    """K6: four revisits of 18 ascending stages alternating the strides
    2^(10 + i % 8) (even i) and 2^(i % 7) (odd i)."""
    return _stages_plain(x, GRID2D_BITS * GRID2D_REVISITS)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
@functools.cache
def _lib():
    """The library, bound once a process."""
    from subphaser_torch import kernels

    lib = kernels.load("sort_primitives")
    if (lib.sp_cluster_tile_bits(), lib.sp_cluster_block_bits()) != (CTA_BITS, BLOCK_BITS):
        raise RuntimeError("sort_primitives library was built with another cluster block")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sp_block_sort_cluster.argtypes = [ptr, ptr, i32, ptr]
    lib.sp_run_stages_cluster.argtypes = [ptr, ptr, i64, ctypes.c_char_p, i32, i32, ptr]
    lib.sp_descent_masked_warp.argtypes = [ptr, ptr, i64, ptr]
    lib.sp_descent_grid2d_warp.argtypes = [ptr, ptr, i64, ptr]
    lib.sp_elementwise_chain.argtypes = [ptr, ptr, i64, i32, ptr]
    lib.sp_transpose_tiles.argtypes = [ptr, ptr, i64, i32, ptr]
    lib.sp_cluster_occupancy.argtypes = [i64, ctypes.POINTER(i32)]
    for fn in (lib.sp_block_sort_cluster, lib.sp_run_stages_cluster, lib.sp_descent_masked_warp,
               lib.sp_descent_grid2d_warp, lib.sp_elementwise_chain, lib.sp_transpose_tiles,
               lib.sp_cluster_occupancy):
        fn.restype = ctypes.c_int
    lib.sp_error_string.argtypes = [i32]
    lib.sp_error_string.restype = ctypes.c_char_p
    return lib


def clusters_that_fit(n: int = BLOCK, device=None) -> int:
    """How many clusters of the cluster kernel's launch shape for ``n`` keys
    (n / 2^15 CTAs, at most 8 a cluster, 132 KB of shared memory each) the
    card runs at once; the kernel's wrappers raise where it is 0."""
    lib = _lib()
    count = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.sp_cluster_occupancy(n, ctypes.byref(count))
    if err != 0:
        raise RuntimeError("sp_cluster_occupancy failed: " + lib.sp_error_string(err).decode())
    return count.value


def _call(lib, entry: str, src: torch.Tensor, dst: torch.Tensor, *args) -> None:
    """``entry(src, dst, *args, stream)`` on the current stream; raises on
    a launch error."""
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = getattr(lib, entry)(src.data_ptr(), dst.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: " + lib.sp_error_string(err).decode())


def _launch(counter: str, entry: str, x: torch.Tensor, *args) -> torch.Tensor:
    """Calls the library's ``entry(src, dst, *args, stream)`` with ``x`` as
    src and a new tensor as dst, which it returns."""
    src = x.contiguous()
    if src.data_ptr() % 16:  # the warp and elementwise kernels move 16-byte words
        src = src.clone()
    dst = torch.empty_like(src)
    _call(_lib(), entry, src, dst, *args)
    launches[counter] += 1
    entry_launches[entry] = entry_launches.get(entry, 0) + 1
    return dst


def _checked_blocks(name: str, x: torch.Tensor) -> int:
    """Validates a flat int32 array of whole 2^18-key blocks; returns n."""
    _check_tensor(name, x)
    n = x.numel()
    if n == 0 or n % BLOCK:
        raise ValueError(f"{name} needs whole blocks of {BLOCK} keys, got {n}")
    return n


def block_sort_unrolled(x: torch.Tensor) -> torch.Tensor:
    """K3: bitonic phases 1..18 of every 2^18-key block of a power-of-two
    int32 array (phases 1..total_bits when it is smaller), as
    ``block_sort_plain(x, 18)``: one launch of the cluster kernel, its
    phases generated inside it."""
    total_bits = _checked_bits("block_sort_unrolled", x)
    if x.device.type == "cpu":
        return block_sort_plain(x, BLOCK_BITS)
    return _launch("block_sort_unrolled", "sp_block_sort_cluster", x, total_bits)


def block_map(name: str, x: torch.Tensor) -> torch.Tensor:
    """K4: candidate ``name`` over every block of ``x``."""
    if name not in BLOCK_MAP_CANDIDATES:
        raise ValueError(f"unknown block_map candidate {name!r}")
    n = _checked_blocks("block_map", x)
    if x.device.type == "cpu":
        return block_map_plain(name, x)
    if name == "elementwise30":
        return _launch("block_map", "sp_elementwise_chain", x, n, ELEMENTWISE_ITERS)
    if name == "transpose8":
        return _launch("block_map", "sp_transpose_tiles", x, n, TRANSPOSE_REPS)
    bits = STAGE_BITS[name]
    return _launch("block_map", "sp_run_stages_cluster", x, n, bytes(bits), len(bits), -1)


def descent_masked(x: torch.Tensor) -> torch.Tensor:
    """K5 (see :func:`descent_masked_plain`)."""
    n = _checked_blocks("descent_masked", x)
    if x.device.type == "cpu":
        return descent_masked_plain(x)
    return _launch("descent_masked", "sp_descent_masked_warp", x, n)


def descent_grid2d(x: torch.Tensor) -> torch.Tensor:
    """K6 (see :func:`descent_grid2d_plain`): all four revisits in one
    launch, each tile in one warp's registers throughout."""
    n = _checked_blocks("descent_grid2d", x)
    if x.device.type == "cpu":
        return descent_grid2d_plain(x)
    return _launch("descent_grid2d", "sp_descent_grid2d_warp", x, n)


def candidates() -> dict:
    """Every candidate of the sort-primitives tool, by the JAX tool's names
    (plus the two block sorts): name -> function of a flat int32 tensor."""
    from subphaser_torch.ops.sort_smem import block_sort

    fns = {name: (lambda x, _n=name: block_map(_n, x)) for name in BLOCK_MAP_CANDIDATES}
    fns["descent18_masked"] = descent_masked
    fns["descent18_grid2d"] = descent_grid2d
    fns["block_sort"] = block_sort
    fns["block_sort_unrolled"] = block_sort_unrolled
    return fns


def plain_versions() -> dict:
    """name -> plain PyTorch version, same keys as :func:`candidates`."""
    fns = {name: (lambda x, _n=name: block_map_plain(_n, x)) for name in BLOCK_MAP_CANDIDATES}
    fns["descent18_masked"] = descent_masked_plain
    fns["descent18_grid2d"] = descent_grid2d_plain
    fns["block_sort"] = block_sort_plain
    fns["block_sort_unrolled"] = lambda x: block_sort_plain(x, BLOCK_BITS)
    return fns
