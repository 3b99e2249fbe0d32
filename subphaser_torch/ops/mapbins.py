"""Map subgenome-specific k-mers back onto genome bins (device).

Replaces the reference's per-position dict lookup over every base of the
genome (reference Seqs.py:74-153, 209-244) with:

1. forward-strand codes for every position (ops/kmer.forward_codes; the
   reference's lookup dict holds each significant k-mer AND its reverse
   complement, so forward matching reproduces both-strand hits),
2. membership + SG id by binary search into the sorted significant-code
   table (``torch.searchsorted``; ops/mapbins_dense replaces this with a
   direct 4^k table for k <= 15 on big genomes),
3. per-(bin, SG) counting without a sort: bins are contiguous position
   ranges, so position-ordered hit rows are placed at offset
   ``start % bin_size`` and reduced by a reshape-sum.

The distinct-hit statistic (the mapping-rate log line, reference
Seqs.py:114-117) is carried as a sorted-unique hit list per batch, merged
in HitSet. Its keys-only sorts go through the bitonic kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from subphaser_torch.ops.count import (
    _compact_survivors,
    _concat_pow2,
    _sort_only,
    _sorted_run_survivors,
)
from subphaser_torch.ops.kmer import SENTINEL, forward_codes
from subphaser_torch.ops.sort_smem import sort_int32


def _place(rows: torch.Tensor, offset: int, width: int) -> torch.Tensor:
    """(n_sg, L) rows written into zeros (n_sg, width) at column ``offset``
    (clamped so the rows fit, like XLA's dynamic_update_slice)."""
    n_sg, length = rows.shape
    offset = max(0, min(int(offset), width - length))
    arr = torch.zeros((n_sg, width), dtype=torch.int32, device=rows.device)
    arr[:, offset : offset + length] = rows
    return arr


def bin_counts_contiguous(hit, sg, start: int, *, bin_size: int, n_sg: int,
                          nbins_tile: int):
    """(16, W) hit/sg grids -> (nbins_tile, n_sg) int32 counts, no sort.

    Flat position offset within the tile is w*16 + p, so swapping the
    (p, w) axes yields position order.
    """
    n_pos = hit.shape[0] * hit.shape[1]
    ids = torch.arange(n_sg, dtype=sg.dtype, device=sg.device)[:, None, None]
    rows = (hit[None] & (sg[None] == ids)).to(torch.int32)  # (n_sg, 16, W)
    pos_rows = rows.transpose(1, 2).reshape(n_sg, n_pos)
    arr = _place(pos_rows, int(start) % bin_size, nbins_tile * bin_size)
    return arr.reshape(n_sg, nbins_tile, bin_size).sum(2, dtype=torch.int32).T


def bin_counts_colsum(hit, sg, start: int, *, bin_size: int, n_sg: int,
                      nbins_tile: int):
    """(16, W) hit/sg grids -> (nbins_tile, n_sg) counts via COLUMN sums.

    Requires ``bin_size % 16 == 0`` and 16-aligned tile starts: each
    word-column's 16 positions then belong to one bin, so the 16 offsets
    are summed first.
    """
    cpb = bin_size // 16  # columns per bin
    ids = torch.arange(n_sg, dtype=sg.dtype, device=sg.device)[:, None, None]
    colsum = (hit[None] & (sg[None] == ids)).sum(1, dtype=torch.int32)  # (n_sg, W)
    arr = _place(colsum, (int(start) % bin_size) // 16, nbins_tile * cpb)
    return arr.reshape(n_sg, nbins_tile, cpb).sum(2, dtype=torch.int32).T


def bin_counts_auto(hit, sg, start: int, *, bin_size: int, n_sg: int,
                    nbins_tile: int, aligned16: bool):
    """Dispatch to the column-sum path when alignment allows."""
    fn = bin_counts_colsum if (aligned16 and bin_size % 16 == 0) \
        else bin_counts_contiguous
    return fn(hit, sg, start, bin_size=bin_size, n_sg=n_sg, nbins_tile=nbins_tile)


def distinct_hits(hidx_flat: torch.Tensor, cap: int) -> torch.Tensor:
    """Flat hit values (SENTINEL = miss) -> sorted unique, SENTINEL-padded
    to ``cap`` entries (cap is clipped to the input size). Two keys-only
    sorts: the first groups duplicates, the second compacts the run ends."""
    n = hidx_flat.numel()
    s = sort_int32(hidx_flat.reshape(-1).to(torch.int32))
    end = torch.ones(n, dtype=torch.bool, device=s.device)
    end[:-1] = s[:-1] != s[1:]
    u = sort_int32(torch.where(end, s, SENTINEL))
    return u[: min(cap, n)]


def _lookup(fcodes, sig_codes, sig_sg):
    """Forward codes -> (hit bool, sg, sig index) by binary search."""
    m = sig_codes.numel()
    idx = torch.searchsorted(sig_codes, fcodes.reshape(-1)).reshape(fcodes.shape)
    idx_c = idx.clamp_max(m - 1)
    hit = (idx < m) & (sig_codes[idx_c] == fcodes) & (fcodes != SENTINEL)
    return hit, sig_sg[idx_c], idx_c


def map_tile_bins(words, vwords, sig_codes, sig_sg, start: int, *, k: int,
                  n_pos_words: int, bin_size: int, n_sg: int, nbins_tile: int,
                  aligned16: bool = False):
    """One tile -> (bin_counts int32 (nbins_tile, n_sg), first_bin, hits:
    sorted unique sig-table indices hit, SENTINEL-padded)."""
    fcodes = forward_codes(words, vwords, k, n_pos_words)  # (16, W)
    hit, sg, idx_c = _lookup(fcodes, sig_codes, sig_sg)
    bin_counts = bin_counts_auto(
        hit, sg, start, bin_size=bin_size, n_sg=n_sg, nbins_tile=nbins_tile,
        aligned16=aligned16,
    )
    hidx = torch.where(hit, idx_c.to(torch.int32), SENTINEL)
    return bin_counts, int(start) // bin_size, distinct_hits(hidx, sig_codes.numel())


def map_tiles_batch(words, vwords, sig_codes, sig_sg, starts, *, k: int,
                    n_pos_words: int, bin_size: int, n_sg: int, nbins_tile: int,
                    aligned16: bool = False):
    """(T, n_words) tiles -> ((T, nbins_tile, n_sg) counts, merged distinct
    hit list). The distinct-hit sort runs once per batch."""
    bcs, hidxs = [], []
    for w, v, s in zip(words, vwords, starts):
        fcodes = forward_codes(w, v, k, n_pos_words)
        hit, sg, idx_c = _lookup(fcodes, sig_codes, sig_sg)
        bcs.append(bin_counts_auto(
            hit, sg, int(s), bin_size=bin_size, n_sg=n_sg,
            nbins_tile=nbins_tile, aligned16=aligned16,
        ))
        hidxs.append(torch.where(hit, idx_c.to(torch.int32), SENTINEL).reshape(-1))
    return torch.stack(bcs), distinct_hits(torch.cat(hidxs), sig_codes.numel())


def nbins_for_tile(tile_bases: int, bin_size: int) -> int:
    return tile_bases // bin_size + 2


def _as_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)


class HitSet:
    """Device-side accumulator of distinct significant-k-mer hits.

    Each ``add`` receives a sorted-unique SENTINEL-padded hit array (one per
    batch, or a host snapshot on resume); parts are consolidated in one
    sort whenever the pending total exceeds ``budget`` entries. ``count``
    returns the number of distinct values.
    """

    def __init__(self, budget: int = 1 << 26, device: torch.device | str = "cuda"):
        self.budget = budget
        self.device = torch.device(device)
        self.parts: list[torch.Tensor] = []
        self.pending = 0

    def add(self, hits) -> None:
        hits = _as_device(hits, self.device)
        self.parts.append(hits)
        self.pending += hits.numel()
        if self.pending > self.budget and len(self.parts) > 1:
            self._consolidate()

    def _consolidate(self) -> None:
        s = _sort_only(_concat_pow2(self.parts))
        runs = _sorted_run_survivors(s, 1)
        cap = min(1 << max(int(runs.m) - 1, 1).bit_length(), s.numel())
        u, _c = _compact_survivors(runs, max(cap, 1))
        self.parts = [u]
        self.pending = u.numel()

    def count(self) -> int:
        if not self.parts:
            return 0
        return int(_sorted_run_survivors(_sort_only(_concat_pow2(self.parts)), 1).m)

    def snapshot(self) -> np.ndarray:
        """Distinct hits as a sorted host array (SENTINEL stripped); the
        per-chromosome mapping checkpoint stores it."""
        if not self.parts:
            return np.zeros(0, dtype=np.int32)
        if len(self.parts) > 1:
            self._consolidate()
        u = self.parts[0].cpu().numpy()
        return u[u != SENTINEL]


class BinAccumulator:
    """Accumulates per-tile bin counts into per-chromosome dense host arrays;
    distinct-hit bookkeeping stays on device (HitSet)."""

    def __init__(self, chrom_sizes: list[int], bin_size: int, n_sg: int,
                 device: torch.device | str = "cuda"):
        self.bin_size = bin_size
        self.n_sg = n_sg
        self.per_chrom = [
            np.zeros((-(-size // bin_size), n_sg), dtype=np.int64) for size in chrom_sizes
        ]
        self._hits = HitSet(device=device)
        self.mapped_positions = 0

    def add(self, chrom_index: int, bin_counts, first_bin: int, hits=None) -> None:
        bc = bin_counts.cpu().numpy() if isinstance(bin_counts, torch.Tensor) \
            else np.asarray(bin_counts)
        arr = self.per_chrom[chrom_index]
        nb = arr.shape[0]
        lo = int(first_bin)
        hi = min(lo + bc.shape[0], nb)
        if hi > lo:
            arr[lo:hi] += bc[: hi - lo]
        self.mapped_positions += int(bc.sum())
        if hits is not None:
            self._hits.add(hits)

    @property
    def mapped_kmer_count(self) -> int:
        return self._hits.count()
