"""Ascending sort of power-of-two int32 arrays: the CUDA radix sort, the
CUDA bitonic sort, and the plain PyTorch version of each.

Counterpart of the JAX package's Pallas VMEM bitonic sort (ops/sort_vmem.py,
kernels K1 `_block_sort_kernel_grid` and K2 `_descent_kernel`). Every
keys-only sort of the port's counting and mapping paths goes through
:func:`sort_int32_pow2`, which takes one of two routes by size, the same on
both devices:

- up to 2^BLK_BITS keys, the bitonic network of one block: on a CUDA tensor
  one launch of ``block_sort`` of ``csrc/bitonic_sort.cu``, on a CPU tensor
  :func:`bitonic_sort_plain`;
- above, a least-significant-digit radix sort: on a CUDA tensor
  ``csrc/radix_sort.cu`` (4 passes of 8-bit digits, see its head note), on a
  CPU tensor :func:`radix_sort_plain`, the same schedule with narrower
  digits.

A CUDA tensor launches its kernel or raises. :func:`bitonic_sort_int32_pow2`
keeps the whole bitonic sort (the block-structured counterpart of K1 and K2)
reachable at every size.

Bitonic schedule (kernel and plain, ``BLK = 2^blk_bits`` keys per block):
bitonic phases 1..blk_bits inside each block, direction from bit p of the
global index; then for each merge level p > blk_bits the cross-block strides
2^(p-1)..BLK as whole-array stages, followed by a descent over strides
BLK/2..1 with one direction per block (bit p - blk_bits of the block id).

Radix schedule (kernel and plain, tiles of ``2^tile_bits`` keys, digits of
``digit_bits`` bits of ``key ^ 0x80000000``, lowest digit first): per pass
the digit histogram of every tile, laid out digit-major; the exclusive scan
of each digit's row over tiles and of the digit totals; the stable rank of
every key among its tile's keys of the same digit; then key -> base[digit]
+ row_scan[digit][tile] + rank, out of place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

SENTINEL = int(np.iinfo(np.int32).max)
BLK_BITS = 13  # keys per CUDA block = 2^13 (32 KB of shared memory)

CPU_DIGIT_BITS = 4  # digit width of the CPU route (the kernel's is 8)

launches = 0  # kernel launches through sort_int32_pow2 (whole sorts)
route_launches = {"block_sort": 0, "radix": 0}  # the same launches by route
bitonic_launches = 0  # whole sorts through bitonic_sort_int32_pow2


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


def radix_sort_plain(x: torch.Tensor, digit_bits: int = 8,
                     tile_bits: int = BLK_BITS) -> torch.Tensor:
    """The radix kernel's schedule in plain PyTorch (no torch.sort), any
    device: per pass and tile the digit histogram and each key's stable
    rank among the tile's keys of its digit (one sweep per digit value),
    the digit-major exclusive scans, and the scatter."""
    t = _pow2_bits(x.numel())
    if not 1 <= digit_bits <= 16 or tile_bits < 1:
        raise ValueError(f"radix_sort_plain: bad digit_bits={digit_bits} tile_bits={tile_bits}")
    n = 1 << t
    tile = 1 << min(tile_bits, t)
    ntiles = n // tile
    radix = 1 << digit_bits
    tile_of = torch.arange(ntiles, device=x.device)[:, None]
    y = x.reshape(-1).clone()
    for shift in range(0, 32, digit_bits):
        biased = y.view(ntiles, tile).to(torch.int64) + (1 << 31)  # key ^ 0x80000000, unsigned
        digit = (biased >> shift) & (radix - 1)
        hist = torch.empty(radix, ntiles, dtype=torch.int64, device=x.device)
        rank = torch.zeros(ntiles, tile, dtype=torch.int64, device=x.device)
        for d in range(radix):
            m = digit == d
            seen = torch.cumsum(m, dim=1)
            hist[d] = seen[:, -1]
            rank = torch.where(m, seen - 1, rank)
        row_scan = torch.cumsum(hist, dim=1) - hist
        totals = hist.sum(dim=1)
        base = torch.cumsum(totals, dim=0) - totals
        dst = base[digit] + row_scan[digit, tile_of] + rank
        out = torch.empty_like(y)
        out[dst.reshape(-1)] = y
        y = out
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


def _radix_kernel_call(x: torch.Tensor, total_bits: int) -> torch.Tensor:
    """Run ``csrc/radix_sort.cu`` on ``x`` (read only) and return the
    sorted keys in a new tensor."""
    from subphaser_torch import kernels

    lib = kernels.load("radix_sort")
    ptr = ctypes.c_void_p
    lib.radix_sort_int32.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_int, ptr]
    lib.radix_sort_int32.restype = ctypes.c_int
    lib.radix_scratch_words.argtypes = [ctypes.c_int]
    lib.radix_scratch_words.restype = ctypes.c_longlong
    lib.radix_error_string.argtypes = [ctypes.c_int]
    lib.radix_error_string.restype = ctypes.c_char_p
    if lib.radix_tile_bits() != BLK_BITS:
        raise RuntimeError("radix_sort library was built with another tile size")
    src = x.reshape(-1)
    if not src.is_contiguous() or src.data_ptr() % 16:
        src = src.clone(memory_format=torch.contiguous_format)  # 16-byte loads
    a, b = torch.empty_like(src), torch.empty_like(src)
    scratch = torch.empty(lib.radix_scratch_words(total_bits), dtype=torch.int32,
                          device=src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.radix_sort_int32(src.data_ptr(), a.data_ptr(), b.data_ptr(),
                                   scratch.data_ptr(), total_bits, stream)
    if err != 0:
        raise RuntimeError(
            "radix_sort_int32 launch failed: " + lib.radix_error_string(err).decode())
    return b


def sort_int32_pow2(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D int32 tensor whose size is a power of two
    (>= 2). Callers pad with SENTINEL (int32 max), which trails."""
    total_bits = _checked_bits("sort_int32_pow2", x)
    if x.device.type == "cpu":
        if total_bits <= BLK_BITS:
            return bitonic_sort_plain(x)
        return radix_sort_plain(x, digit_bits=CPU_DIGIT_BITS)
    route = "block_sort" if total_bits <= BLK_BITS else "radix"
    if route == "block_sort":
        y = _kernel_call("bitonic_block_sort_int32", x, total_bits)
    else:
        y = _radix_kernel_call(x, total_bits)
    global launches
    launches += 1
    route_launches[route] += 1
    return y


def bitonic_sort_int32_pow2(x: torch.Tensor) -> torch.Tensor:
    """The same function through the whole bitonic sort at every size:
    ``bitonic_sort_int32`` of csrc/bitonic_sort.cu on a CUDA tensor,
    :func:`bitonic_sort_plain` on a CPU tensor."""
    total_bits = _checked_bits("bitonic_sort_int32_pow2", x)
    if x.device.type == "cpu":
        return bitonic_sort_plain(x)
    y = _kernel_call("bitonic_sort_int32", x, total_bits)
    global bitonic_launches
    bitonic_launches += 1
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
