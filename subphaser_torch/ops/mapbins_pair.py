"""Significant-k-mer bin mapping for pair codes (k in [16, 31]).

The JAX package searches the sorted significant-code table in two levels:
a binary search on the hi words, then an unrolled probe over the run of
equal-hi entries comparing lo (:func:`max_hi_run` gives the probe depth).
Here the table is one sorted int64 key ``hi << 31 | lo``, so a single
``torch.searchsorted`` finds the same entry: the table holds distinct
codes, hence the first probe hit and the leftmost equal key are the same
index. That index also feeds the distinct-hit statistic, whose int32 sorts
go through the bitonic kernel (ops/mapbins.distinct_hits). Each tile's
codes, search and hit test are one device span, ``search``, relative to the
caller's step (utils/profiling; ``map/search`` under mapping).
"""

from __future__ import annotations

import numpy as np
import torch

from subphaser_torch.ops.kmer import SENTINEL
from subphaser_torch.ops.kmer_pair import PAD64, forward_codes64
from subphaser_torch.ops.mapbins import (
    BinAccumulator,
    bin_counts_auto,
    distinct_hits,
    nbins_for_tile,
)
from subphaser_torch.utils.profiling import span


def max_hi_run(sig_codes64: np.ndarray) -> int:
    """Longest run of equal hi words in the sorted sig table (the JAX
    package's probe depth; reported in the mapping log)."""
    hi = (np.asarray(sig_codes64, dtype=np.int64) >> 31).astype(np.int32)
    if hi.size == 0:
        return 1
    change = np.flatnonzero(np.diff(hi))
    bounds = np.concatenate([[-1], change, [hi.size - 1]])
    return int(np.max(np.diff(bounds)))


def map_tile_bins_pair(words, vwords, sig_codes64, sig_sg, start: int, *, k: int,
                       n_pos_words: int, bin_size: int, n_sg: int, nbins_tile: int):
    """One tile -> (bin_counts int32 (nbins_tile, n_sg), first_bin, hits:
    sorted unique sig-table indices hit, SENTINEL-padded).

    ``sig_codes64``: sorted distinct int64 codes (m >= 1); ``sig_sg``: int32
    SG index per code."""
    with span("search", device=True):
        fcodes = forward_codes64(words, vwords, k, n_pos_words)  # (16, W)
        m = sig_codes64.numel()
        idx = torch.searchsorted(sig_codes64, fcodes.reshape(-1)).reshape(fcodes.shape)
        idx_c = idx.clamp_max(m - 1)
        # pad = the (SENTINEL, SENTINEL) PAIR: at k = 31 forward codes can
        # legitimately carry hi == SENTINEL (T^15[G/T]-prefixed windows);
        # only exact T^31 windows alias the pad (see ops/kmer_pair)
        hit = (idx < m) & (sig_codes64[idx_c] == fcodes) & (fcodes != PAD64)
    bin_counts = bin_counts_auto(
        hit, sig_sg[idx_c], start, bin_size=bin_size, n_sg=n_sg,
        nbins_tile=nbins_tile, aligned16=bin_size % 16 == 0,
    )
    midx = torch.where(hit, idx_c.to(torch.int32), SENTINEL)
    return bin_counts, int(start) // bin_size, distinct_hits(midx, m)


def map_genome_bins_pair(genome, sig_codes64, sig_sg, k, tile_bases, bin_size, n_sg,
                         device: torch.device | str = "cuda") -> BinAccumulator:
    """Map pair-code significant k-mers over a packed genome."""
    device = torch.device(device)
    codes = torch.from_numpy(np.ascontiguousarray(sig_codes64, dtype=np.int64)).to(device)
    sgs = torch.from_numpy(np.ascontiguousarray(sig_sg, dtype=np.int32)).to(device)
    acc = BinAccumulator([c.length for c in genome.chroms], bin_size, n_sg, device=device)
    nbt = nbins_for_tile(tile_bases, bin_size)
    for t in genome.tiles(k, tile_bases=tile_bases):
        bc, fb, hits = map_tile_bins_pair(
            torch.from_numpy(t.words).to(device), torch.from_numpy(t.vwords).to(device),
            codes, sgs, t.start, k=k, n_pos_words=tile_bases // 16,
            bin_size=bin_size, n_sg=n_sg, nbins_tile=nbt,
        )
        acc.add(t.chrom_index, bc, fb, hits)
    return acc
