"""Sort-based counting for pair codes (k in [16, 31]).

Mirror of ops/count.py with (hi, lo) int32 key pairs at every function's
boundary, as in the JAX package. Inside, a pair is the single int64 key
``hi << 31 | lo``: the JAX package's two-key sorts (XLA's, outside any
hand-written kernel) become ``torch.sort`` on that key, run boundaries
compare it, and the host gets int64 codes. The pad is the pair
(SENTINEL, SENTINEL) = PAD64, which sorts last; pad tests look at the hi
word only, which is exact for canonical codes even at k = 31 (see
ops/kmer_pair). The run-length passes are ops/count's, whose ``run_scan``
and ``run_compact`` take int64 keys (``csrc/runs.cu``'s 64-bit
instantiation on a CUDA tensor, the plain version on a CPU tensor) and
write the survivors' hi and lo words directly; that yields the same bits as
the JAX package's prefix-maximum scan and sort-based compaction: survivors
of a sorted array are already in order.

Each pass is a span (utils/profiling) at the paths of ops/count's int32
passes, relative to its caller's step: ``codes``, ``sort`` (keys-only
int64 sorts, whose keys add to the counter ``sort@int64_keys``), ``runs``,
``compact``, ``merge`` (its compaction ``merge/compact``) are device spans;
``collect`` is each read-back to the host and the host merge.
"""

from __future__ import annotations

import numpy as np
import torch

from subphaser_torch.ops.count import (
    _compact_survivors,
    _is_pad,
    _merge_sorted_runs,
    _out_cap,
    _pad_to,
    _sorted_run_survivors,
    merge_host,
)
from subphaser_torch.ops.kmer_pair import PAD64, combine64_t, kmer_codes64, split64_t
from subphaser_torch.utils.profiling import count, span


def _codes64_batch(words, vwords, k: int, n_pos_words: int) -> torch.Tensor:
    with span("codes", device=True):
        if words.dim() == 1:
            return kmer_codes64(words, vwords, k, n_pos_words).reshape(-1)
        return torch.cat([kmer_codes64(w, v, k, n_pos_words).reshape(-1)
                          for w, v in zip(words, vwords)])


def _sort64(code: torch.Tensor) -> torch.Tensor:
    """Keys-only ascending sort of int64 keys."""
    with span("sort", device=True):
        count("int64_keys", code.numel())
        return torch.sort(code).values


def sort_rle_pair(hi: torch.Tensor, lo: torch.Tensor):
    """Sort + scan RLE + compaction (full width): (hi, lo, counts)."""
    return _sort_rle64(combine64_t(hi.reshape(-1), lo.reshape(-1)))


def _compact_pair(runs, cap: int):
    """The survivors at the pair boundary: (hi, lo, counts)."""
    planes, counts = _compact_survivors(runs, cap)
    return planes[0], planes[1], counts


def _sort_rle64(code: torch.Tensor):
    s = _sort64(code)
    return _compact_pair(_sorted_run_survivors(s, 1), s.numel())


def count_tile_batch_pair(words, vwords, k: int, n_pos_words: int):
    """(T, n_words) packed tiles -> one merged pair spectrum."""
    return _sort_rle64(_codes64_batch(words, vwords, k, n_pos_words))


def extract_pair_codes_batch(words, vwords, k: int, n_pos_words: int):
    """(T, n_words) packed tiles -> flat (hi, lo) canonical pair codes."""
    return split64_t(_codes64_batch(words, vwords, k, n_pos_words))


def _concat_pad_pow2(parts):
    """Concat (hi, lo) parts into int64 codes, PAD64-padded to a power of
    two."""
    hi = torch.cat([p[0].reshape(-1) for p in parts])
    lo = torch.cat([p[1].reshape(-1) for p in parts])
    total = hi.numel()
    cap = 1 << max(total - 1, 1).bit_length()
    return _pad_to(combine64_t(hi, lo), cap, PAD64)


def merge_rle_many_pair(parts, lower_count: int = 1):
    """Merge pair spectra in one sort, compacted to the (pow2-bucketed)
    survivor count (see count.merge_rle_many)."""
    if len(parts) == 1 and lower_count <= 1:
        return parts[0]
    with span("merge", device=True):
        code = _concat_pad_pow2(parts)
        counts = _pad_to(torch.cat([p[2] for p in parts]), code.numel(), 0)
        runs = _merge_sorted_runs(code, counts, lower_count)
        return _compact_pair(runs, _out_cap(int(runs.m), code.numel()))


def _to_host(hi, lo, counts) -> tuple[np.ndarray, np.ndarray]:
    """Device (hi, lo, counts) -> host (int64 codes, int64 counts), pad
    entries dropped."""
    with span("collect"):
        code = combine64_t(hi, lo)
        m = ~_is_pad(code)
        return code[m].cpu().numpy(), counts[m].cpu().numpy().astype(np.int64)


def count_pair_codes_threshold(parts, lower_count: int):
    """Raw (hi, lo) code parts -> host (int64 codes, int64 counts) with
    count >= lower_count: one sort over the chromosome, scan RLE, one
    right-sized compaction."""
    if not parts:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    s = _sort64(_concat_pad_pow2(parts))
    runs = _sorted_run_survivors(s, lower_count)
    return _to_host(*_compact_pair(runs, _out_cap(int(runs.m), s.numel())))


class PairSpectrumAccumulator:
    """Pair-code version of SpectrumAccumulator; finish() returns int64 codes."""

    def __init__(self, device_budget: int = 1 << 28):
        self.device_budget = device_budget
        self.parts: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        self.pending = 0
        self.spilled: list[tuple[np.ndarray, np.ndarray]] = []

    def add(self, hi, lo, counts) -> None:
        self.parts.append((hi, lo, counts))
        self.pending += hi.numel()
        if self.pending > self.device_budget:
            merged = merge_rle_many_pair(self.parts)
            self.parts = [merged]
            self.pending = merged[0].numel()
            if self.pending > self.device_budget:
                self.spilled.append(_to_host(*merged))
                self.parts = []
                self.pending = 0

    def finish(self, lower_count: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Merge everything; apply the per-chromosome dump threshold."""
        if not self.spilled and lower_count > 1 and self.parts:
            merged = merge_rle_many_pair(self.parts, lower_count)
            self.parts = []
            self.pending = 0
            return _to_host(*merged)
        parts = list(self.spilled)
        if self.parts:
            parts.append(_to_host(*merge_rle_many_pair(self.parts)))
        self.parts = []
        self.pending = 0
        self.spilled = []
        with span("collect"):
            codes, counts = merge_host(parts)
            if lower_count > 1:
                keep = counts >= lower_count
                codes, counts = codes[keep], counts[keep]
        return codes, counts
