"""Ascending sort of power-of-two int32 arrays: CUDA bitonic kernel + its
plain PyTorch network.

Counterpart of the JAX package's Pallas VMEM bitonic sort (ops/sort_vmem.py,
kernels K1 `_block_sort_kernel_grid` and K2 `_descent_kernel`). Every
keys-only sort of the port's counting and mapping paths goes through
:func:`sort_int32_pow2`:

- a CPU tensor takes :func:`bitonic_sort_plain`, the same network in
  vectorised ``min``/``max`` over reshaped views;
- a CUDA tensor launches ``csrc/bitonic_sort.cu`` or raises.

Schedule (shared by both, with ``BLK = 2^blk_bits`` keys per block): bitonic
phases 1..blk_bits inside each block, direction from bit p of the global
index; then for each merge level p > blk_bits the cross-block strides
2^(p-1)..BLK as whole-array stages, followed by a descent over strides
BLK/2..1 with one direction per block (bit p - blk_bits of the block id).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

SENTINEL = int(np.iinfo(np.int32).max)
BLK_BITS = 13  # keys per CUDA block = 2^13 (32 KB of shared memory)

launches = 0  # kernel launches through sort_int32_pow2 (whole sorts)


def _pow2_bits(n: int) -> int:
    bits = n.bit_length() - 1
    if n < 2 or n != 1 << bits:
        raise ValueError(f"sort_int32_pow2 needs a power-of-two size >= 2, got {n}")
    return bits


def _stage(y: torch.Tensor, sb: int, p: int) -> torch.Tensor:
    """Compare-exchange at stride 2^sb of merge level p over the whole
    array; pair group g sorts descending iff bit p of its first index is
    set, i.e. bit (p - sb - 1) of g."""
    n = y.numel()
    s = 1 << sb
    v = y.view(n // (2 * s), 2, s)
    lo, hi = v[:, 0], v[:, 1]
    mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
    g = torch.arange(n // (2 * s), device=y.device)
    d = (((g >> (p - sb - 1)) & 1) == 1)[:, None]
    return torch.stack([torch.where(d, mx, mn), torch.where(d, mn, mx)], dim=1).reshape(-1)


def _descent(y: torch.Tensor, p: int, blk_bits: int) -> torch.Tensor:
    """Strides BLK/2..1 of level p > blk_bits with one direction per block."""
    blk = 1 << blk_bits
    nb = y.numel() // blk
    d_blk = ((torch.arange(nb, device=y.device) >> (p - blk_bits)) & 1) == 1
    for sb in range(blk_bits - 1, -1, -1):
        s = 1 << sb
        v = y.view(nb, blk // (2 * s), 2, s)
        lo, hi = v[:, :, 0], v[:, :, 1]
        mn, mx = torch.minimum(lo, hi), torch.maximum(lo, hi)
        d = d_blk[:, None, None]
        y = torch.stack([torch.where(d, mx, mn), torch.where(d, mn, mx)], dim=2).reshape(-1)
    return y


def block_sort_plain(x: torch.Tensor, blk_bits: int = BLK_BITS) -> torch.Tensor:
    """Phase (a) alone: bitonic phases 1..blk_bits inside each block of
    2^blk_bits keys, the direction of a pair from bit p of its global index
    (so blocks alternate ascending / descending after the last phase, and
    an array of one block comes out ascending)."""
    y = x.reshape(-1).clone()
    for p in range(1, min(_pow2_bits(y.numel()), blk_bits) + 1):
        for sb in range(p - 1, -1, -1):
            y = _stage(y, sb, p)
    return y


def bitonic_sort_plain(x: torch.Tensor, blk_bits: int = BLK_BITS) -> torch.Tensor:
    """The kernel's network in plain PyTorch (no torch.sort), any device."""
    t = _pow2_bits(x.numel())
    local = min(t, blk_bits)
    y = block_sort_plain(x, blk_bits)      # (a) block sort
    for p in range(local + 1, t + 1):
        for sb in range(p - 1, local - 1, -1):  # (b) global stages
            y = _stage(y, sb, p)
        y = _descent(y, p, local)          # (c) merge descent
    return y


def _kernel_call(entry: str, x: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Copy ``x`` and run the library's in-place ``entry`` on the copy."""
    from subphaser_torch import kernels

    lib = kernels.load("bitonic_sort")
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bitonic_error_string.argtypes = [ctypes.c_int]
    lib.bitonic_error_string.restype = ctypes.c_char_p
    if lib.bitonic_blk_bits() != BLK_BITS:
        raise RuntimeError("bitonic_sort library was built with another BLK_BITS")
    y = x.reshape(-1).clone(memory_format=torch.contiguous_format)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = fn(y.data_ptr(), total_bits, stream)
    if err != 0:
        raise RuntimeError(
            f"{entry} launch failed: " + lib.bitonic_error_string(err).decode())
    return y


def _check_tensor(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"{name} needs a 1-D int32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def _checked_bits(name: str, x: torch.Tensor) -> int:
    _check_tensor(name, x)
    return _pow2_bits(x.numel())


def sort_int32_pow2(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D int32 tensor whose size is a power of two
    (>= 2). Callers pad with SENTINEL (int32 max), which trails."""
    total_bits = _checked_bits("sort_int32_pow2", x)
    if x.device.type == "cpu":
        return bitonic_sort_plain(x)
    y = _kernel_call("bitonic_sort_int32", x, total_bits)
    global launches
    launches += 1
    return y


def block_sort(x: torch.Tensor) -> torch.Tensor:
    """Phase (a) of the sort alone (see :func:`block_sort_plain`): the
    looped kernel that the unrolled block sort of ops/sort_primitives is
    held against. Not counted in ``launches`` (no whole sort)."""
    total_bits = _checked_bits("block_sort", x)
    if x.device.type == "cpu":
        return block_sort_plain(x)
    return _kernel_call("bitonic_block_sort_int32", x, total_bits)


def sort_int32(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of any 1-D int32 tensor: SENTINEL-pad to a power of
    two, sort, drop the pad (pad values are the maximum, so they trail)."""
    n = x.numel()
    cap = 1 << max(n - 1, 1).bit_length()
    if cap > n:
        x = torch.cat([x, torch.full((cap - n,), SENTINEL, dtype=x.dtype, device=x.device)])
    return sort_int32_pow2(x)[:n]
