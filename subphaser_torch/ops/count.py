"""Sort-based exact k-mer counting (device) + spectrum accumulation.

One path for every k; its width is the keys' dtype. Codes are int32 for
k <= 15 and int64 ``hi << 31 | lo`` for k in [16, 31] (ops/kmer_pair), and
stay in that dtype from extraction to the host. The pad is SENTINEL, or
PAD64 for int64 keys; both sort last. Per batch of tiles the canonical codes
are sorted and run-length encoded into a sparse (code, count) spectrum,
padded to a fixed length. Keys-only sorts of int32 keys go through the radix
and bitonic kernels (ops/sort_smem, called by their module names here so
that a rebinding reaches them); int64 keys through ``torch.sort``, their
number added to the counter ``sort@int64_keys``. Spectra merge by one
key-value sort (``torch.sort(stable=True)``; the JAX package uses XLA's sort
there too) and the run totals of the sorted counts. Run lengths and run
totals come from the positions of consecutive run ends (:func:`run_scan`,
:func:`run_compact`: ``csrc/runs.cu``'s int32 or int64 instantiation on a
CUDA tensor, their plain versions on a CPU tensor), thresholded and
compacted in order, which yields the same bits as the JAX package's
prefix-maximum scan and sort-based compaction (its pair codes' two-key
sorts and scans included). Each pass is a device span (utils/profiling)
named relative to its caller's step: ``codes``, ``sort``, ``runs``,
``compact`` and ``merge`` (``count/runs`` under counting, ``map/runs`` under
mapping); ``collect`` is a chromosome's one read-back to the host, with the
host merge where there is one.

Replaces jellyfish's hash counting (reference Jellyfish.py:697-703) and its
host dict merge (Jellyfish.py:439-460).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from subphaser_torch.ops.kmer import SENTINEL, kmer_codes
from subphaser_torch.ops.kmer_pair import PAD64, kmer_codes64
from subphaser_torch.ops.sort_smem import sort_int32, sort_int32_pow2
from subphaser_torch.utils.profiling import count, count_launch, span

# csrc/runs.cu launches by C entry
entry_launches = {"rn_count": 0, "rn_write": 0, "rn_count64": 0, "rn_write64": 0}
# its C entries by the keys' dtype: (count, write)
_ENTRIES = {torch.int32: ("rn_count", "rn_write"), torch.int64: ("rn_count64", "rn_write64")}
_launch_lock = threading.Lock()
_lib = None


def code_dtype(k: int) -> torch.dtype:
    """The codes' dtype at ``k``: int32 for k <= 15, int64 pair codes above."""
    return torch.int64 if k > 15 else torch.int32


def fits_one_sort(n_positions: int, k: int, device_budget: int) -> bool:
    """Whether a chromosome's raw codes fit ``device_budget`` (int32 units)
    for the fast path's one sort: int64 codes take two units a position."""
    return n_positions <= device_budget // (code_dtype(k).itemsize // 4)


def _pad_of(keys: torch.Tensor) -> int:
    return PAD64 if keys.dtype == torch.int64 else SENTINEL


def _pad_to(x: torch.Tensor, cap: int, value) -> torch.Tensor:
    if x.numel() >= cap:
        return x[:cap]
    return torch.cat([x, torch.full((cap - x.numel(),), value, dtype=x.dtype, device=x.device)])


def _sort(keys: torch.Tensor, pow2: bool = False) -> torch.Tensor:
    """Keys-only ascending sort of flat keys: int32 by ``sort_int32_pow2``
    (a power-of-two length) or ``sort_int32``; int64 by ``torch.sort``."""
    with span("sort", device=True):
        if keys.dtype == torch.int64:
            count("int64_keys", keys.numel())
            return torch.sort(keys).values
        return sort_int32_pow2(keys) if pow2 else sort_int32(keys)


def sort_rle(codes: torch.Tensor):
    """Sort flat codes and run-length encode.

    Returns (ucodes, counts) of the same length N: unique codes ascending,
    padded with the keys' pad. A trailing run of pad inputs (invalid
    positions) shows up as one pad "code", dropped downstream.
    """
    s = _sort(codes.reshape(-1))
    return _compact_survivors(_sorted_run_survivors(s, 1), s.numel())


def _merge_sorted_runs(codes, counts, lower: int) -> "Runs":
    """Sort (code, count) pairs and take the run totals of the counts
    (:func:`run_scan`)."""
    codes, order = torch.sort(codes, stable=True)
    return run_scan(codes, counts[order], lower)


def merge_rle_many(parts, lower_count: int = 1):
    """Merge many sorted spectra in ONE sort, compacted to the (pow2-
    bucketed) survivor count. ``lower_count`` > 1 also applies the dump
    threshold (only valid when ``parts`` cover all of a chromosome)."""
    if len(parts) == 1 and lower_count <= 1:
        return parts[0]
    with span("merge", device=True):
        cap = _pow2(sum(int(p[0].numel()) for p in parts))
        runs = _merge_sorted_runs(_concat_pow2([p[0] for p in parts]),
                                  _pad_to(torch.cat([p[1] for p in parts]), cap, 0), lower_count)
        return _compact_survivors(runs, _out_cap(int(runs.m), cap))


def extract_codes_batch(words, vwords, k: int, n_pos_words: int):
    """(T, n_words) or (n_words,) packed tiles -> flat canonical codes of
    :func:`code_dtype`."""
    codes_of = kmer_codes64 if code_dtype(k) == torch.int64 else kmer_codes
    with span("codes", device=True):
        if words.dim() == 1:
            return codes_of(words, vwords, k, n_pos_words).reshape(-1)
        return torch.cat([codes_of(w, v, k, n_pos_words).reshape(-1)
                          for w, v in zip(words, vwords)])


def count_tile_batch(words, vwords, k: int, n_pos_words: int):
    """(T, n_words) or (n_words,) packed tiles -> one sorted spectrum (one
    sort)."""
    return sort_rle(extract_codes_batch(words, vwords, k, n_pos_words))


@dataclass
class Runs:
    """One run-length pass over sorted keys (:func:`run_scan`): the survivor
    count ``m`` (a tensor on the keys' device, read by the caller when it
    needs the number) and what :func:`run_compact` writes the survivors
    from."""

    keys: torch.Tensor
    weights: torch.Tensor | None
    lower: int
    m: torch.Tensor
    status: torch.Tensor | None = None   # CUDA: the status words of rn_count
    kept: tuple | None = None            # CPU: the survivors' keys and totals


def runs_lib():
    """csrc/runs.cu, built at first use."""
    global _lib
    with _launch_lock:
        if _lib is None:
            import ctypes

            from subphaser_torch import kernels

            lib = kernels.load("runs")
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rn_scratch_size.argtypes = [i64]
            lib.rn_scratch_size.restype = i64
            for fn in (lib.rn_count, lib.rn_count64):
                fn.argtypes = [ptr, ptr, i64, i32, ptr, ptr, ptr]
                fn.restype = i32
            for fn in (lib.rn_write, lib.rn_write64):
                fn.argtypes = [ptr, ptr, i64, i32, ptr, ptr, i32, ptr, ptr, ptr]
                fn.restype = i32
            lib.rn_error_string.argtypes = [i32]
            lib.rn_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _launched(lib, err: int, entry: str) -> None:
    if err != 0:
        from subphaser_torch.kernels import KernelError

        raise KernelError(f"{entry} launch failed: " + lib.rn_error_string(err).decode())
    with _launch_lock:
        entry_launches[entry] += 1
    count_launch(entry)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` on a 16-byte boundary (the kernel reads 16-byte vectors); a
    view that is not is copied."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _is_pad(keys: torch.Tensor) -> torch.Tensor:
    """The pad keys: SENTINEL of int32 keys; of int64 pair codes those whose
    hi word is SENTINEL (PAD64 is ``SENTINEL << 31 | SENTINEL``; the hi word
    alone is exact for canonical codes, see ops/kmer_pair)."""
    if keys.dtype == torch.int64:
        return (keys >> 31) == SENTINEL
    return keys == SENTINEL


def run_scan_plain(keys: torch.Tensor, weights: torch.Tensor | None, lower: int):
    """The plain version of :func:`run_scan`: the survivors' keys (of the
    keys' dtype) and int32 totals. Run ends are where a key differs from the
    next (and the last entry); a run's length is the difference of
    consecutive run-end positions, its total the difference of the weights'
    prefix sums there."""
    n = keys.numel()
    end = torch.ones(n, dtype=torch.bool, device=keys.device)
    end[:-1] = keys[:-1] != keys[1:]
    ends = torch.nonzero(end).reshape(-1)
    if weights is None:
        at = ends + 1
    else:
        at = torch.cumsum(weights, 0, dtype=torch.int64)[ends]
    total = torch.diff(at, prepend=at.new_zeros(1))
    codes = keys[ends]
    keep = (total >= lower) & ~_is_pad(codes) & (total > 0)
    return codes[keep], total[keep].to(torch.int32)


def _check_runs_input(keys: torch.Tensor, weights: torch.Tensor | None) -> None:
    if keys.dtype not in _ENTRIES or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("run_scan: the keys must be a contiguous 1-D int32 or int64 tensor, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if weights is not None and (weights.dtype != torch.int32 or weights.shape != keys.shape
                                or not weights.is_contiguous()
                                or weights.device != keys.device):
        raise ValueError("run_scan: the weights must be a contiguous int32 tensor of the "
                         "keys' shape and device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"run_scan: unsupported device {keys.device}")
    if keys.numel() >= 1 << 31:
        raise ValueError("run_scan: at most 2^31 - 1 keys")


def run_scan(keys: torch.Tensor, weights: torch.Tensor | None, lower: int) -> Runs:
    """The runs of sorted int32 or int64 ``keys``: each run's length, or with
    int32 ``weights`` (>= 0, one an entry) the total of its weights, below
    2^31; a run survives where total >= lower, its key is not the pad
    (int32: SENTINEL; int64 pair codes: hi word SENTINEL) and its total is
    above 0. Returns a :class:`Runs` whose ``m`` counts the survivors;
    :func:`run_compact` writes them.

    A CUDA tensor launches ``rn_count`` (int32 keys) or ``rn_count64``
    (int64) of csrc/runs.cu (a memset and one kernel; ``m`` stays on the
    card); a CPU tensor takes :func:`run_scan_plain`."""
    _check_runs_input(keys, weights)
    if keys.device.type == "cpu" or keys.numel() == 0:  # no keys: nothing to launch
        kept = run_scan_plain(keys, weights, lower)
        return Runs(keys, weights, lower, torch.tensor(kept[0].numel(), dtype=torch.int32,
                                                       device=keys.device), kept=kept)
    lib = runs_lib()
    dev = keys.device
    keys = _aligned(keys)
    weights = None if weights is None else _aligned(weights)
    n = keys.numel()
    status = torch.empty(lib.rn_scratch_size(n), dtype=torch.int32, device=dev)
    m = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry = _ENTRIES[keys.dtype][0]
        err = getattr(lib, entry)(keys.data_ptr(),
                                  None if weights is None else weights.data_ptr(), n, lower,
                                  m.data_ptr(), status.data_ptr(), stream)
    _launched(lib, err, entry)
    return Runs(keys, weights, lower, m, status=status)


def run_compact(runs: Runs, cap: int):
    """The first ``cap`` survivors of :func:`run_scan` in order, padded from
    the survivor count: (keys, int32 totals), both (cap,), the keys of the
    scanned keys' dtype and padded with their pad (SENTINEL or PAD64), the
    totals 0-padded. A CUDA scan launches ``rn_write`` / ``rn_write64`` of
    csrc/runs.cu; a CPU scan pads or cuts its plain result."""
    if runs.kept is not None:
        return _pad_to(runs.kept[0], cap, _pad_of(runs.keys)), _pad_to(runs.kept[1], cap, 0)
    lib = runs_lib()
    keys, weights = runs.keys, runs.weights
    dev = keys.device
    out_keys = torch.empty(cap, dtype=keys.dtype, device=dev)
    out_tot = torch.empty(cap, dtype=torch.int32, device=dev)
    entry = _ENTRIES[keys.dtype][1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(keys.data_ptr(),
                                  None if weights is None else weights.data_ptr(), keys.numel(),
                                  runs.lower, runs.m.data_ptr(), runs.status.data_ptr(), cap,
                                  out_keys.data_ptr(), out_tot.data_ptr(), stream)
    _launched(lib, err, entry)
    return out_keys, out_tot


def _sorted_run_survivors(s: torch.Tensor, lower: int) -> Runs:
    """Sorted codes -> their runs (:func:`run_scan`, run lengths)."""
    with span("runs", device=True):
        return run_scan(s, None, lower)


def _compact_survivors(runs: Runs, cap: int):
    """Survivor codes + counts, pad/0-padded or cut to ``cap``
    (:func:`run_compact`)."""
    with span("compact", device=True):
        return run_compact(runs, cap)


def _out_cap(m: int, n: int) -> int:
    """The output size of a thresholded count: m survivors rounded up to a
    power of two, at least 2^10 and at most the ``n`` entries scanned."""
    return min(max(_pow2(m), 1 << 10), n)


def _sort_only(codes: torch.Tensor) -> torch.Tensor:
    return _sort(codes.reshape(-1), pow2=True)


def _pow2(n: int) -> int:
    """The next power of two at or above n, at least 2."""
    return 1 << max(n - 1, 1).bit_length()


def _concat_pow2(code_parts):
    """Concat parts + pad (the keys' own) to the next power of two."""
    flat = torch.cat([p.reshape(-1) for p in code_parts])
    return _pad_to(flat, _pow2(flat.numel()), _pad_of(flat))


def _to_host(keys: torch.Tensor, counts: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """Device survivors -> host (keys of their dtype, int64 counts), the
    pads dropped."""
    live = ~_is_pad(keys)
    return keys[live].cpu().numpy(), counts[live].cpu().numpy().astype(np.int64)


def count_codes_threshold(code_parts, lower_count: int, dtype: torch.dtype = torch.int32):
    """Raw code arrays -> host (codes of their dtype, counts int64) with
    count >= lower_count, via ONE keys-only sort of the pow2-padded
    concatenation and a compaction sized to the survivor count. ``dtype``
    is the codes' dtype when there are no parts."""
    if not code_parts:  # zero-length chromosome
        return torch.empty(0, dtype=dtype).numpy(), np.empty(0, np.int64)
    s = _sort_only(_concat_pow2(code_parts))
    runs = _sorted_run_survivors(s, lower_count)
    survivors = _compact_survivors(runs, _out_cap(int(runs.m), s.numel()))
    with span("collect"):
        return _to_host(*survivors)


def merge_host(parts: list[tuple[np.ndarray, np.ndarray]]):
    """Merge many sorted (codes, counts) arrays on host (numpy, vectorized)."""
    if not parts:
        return np.empty(0, np.int32), np.empty(0, np.int64)
    codes = np.concatenate([p[0] for p in parts])
    counts = np.concatenate([p[1].astype(np.int64) for p in parts])
    order = np.argsort(codes, kind="stable")
    codes = codes[order]
    counts = counts[order]
    if codes.size == 0:
        return codes, counts
    start = np.empty(codes.size, dtype=bool)
    start[0] = True
    np.not_equal(codes[1:], codes[:-1], out=start[1:])
    idx = np.flatnonzero(start)
    totals = np.add.reduceat(counts, idx)
    return codes[idx], totals


class SpectrumAccumulator:
    """Accumulates per-batch spectra (keys of either width) into one
    chromosome spectrum.

    Parts stay on device unmerged until ``finish``, which merges everything
    in ONE sort. If the pending parts exceed ``device_budget`` entries they
    are pre-merged, and spilled to host only beyond the budget. Every merge
    goes through :meth:`_merge`.
    """

    def __init__(self, device_budget: int = 1 << 28):
        self.device_budget = device_budget
        self.parts: list[tuple[torch.Tensor, torch.Tensor]] = []
        self.pending = 0
        self.spilled: list[tuple[np.ndarray, np.ndarray]] = []

    def _merge(self, parts, lower_count: int = 1):
        return merge_rle_many(parts, lower_count)

    def add(self, codes: torch.Tensor, counts: torch.Tensor) -> None:
        self.parts.append((codes, counts))
        self.pending += codes.numel()
        if self.pending > self.device_budget:
            merged = self._merge(self.parts)
            self.parts = [merged]
            self.pending = merged[0].numel()
            if self.pending > self.device_budget:
                self.spilled.append(_to_host(*merged))
                self.parts = []
                self.pending = 0

    def finish(self, lower_count: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Merge everything; apply the per-chromosome dump threshold."""
        parts, spilled = self.parts, self.spilled
        self.parts, self.pending, self.spilled = [], 0, []
        if parts and not spilled:
            merged = self._merge(parts, lower_count)
            with span("collect"):
                return _to_host(*merged)
        merged = [self._merge(parts)] if parts else []
        with span("collect"):
            codes, counts = merge_host(spilled + [_to_host(*m) for m in merged])
            if lower_count > 1:
                keep = counts >= lower_count
                codes, counts = codes[keep], counts[keep]
        return codes, counts
