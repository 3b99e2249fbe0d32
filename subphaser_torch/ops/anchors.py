"""Sampled k-mer anchors for whole-chromosome alignment (PyTorch).

Replaces minimap2's minimizer seeding (reference Blocks.py:42-43): canonical
codes are hash-sampled at density 1/mod (the same k-mers in both sequences),
matched by a sorted search, and the colinear chaining runs in the native
library (sp_chain_anchors).

Two hand-written CUDA kernels (csrc/anchors.cu) carry the device work:

- :func:`sampled_anchors` (kernel A): codes, strand, hash sample and the
  ordered compaction of one tile;
- :func:`match_emit` (kernel B): the keep rule of the join and the emission
  of every (qpos, tpos, rel) pair of the kept runs.

A CPU tensor takes their plain versions (:func:`sampled_anchors_plain`,
:func:`match_emit_plain`); a CUDA tensor launches the kernel or raises
:class:`~subphaser_torch.kernels.KernelError`. ``launches[name]`` counts
the wrapper calls that launched a kernel, ``entry_launches[entry]`` the
calls of each C entry point. The sort and the searches
between them are ``torch.sort`` and ``torch.searchsorted``, as the JAX
package left them to XLA.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from subphaser_torch.device import resolve_device
from subphaser_torch.io.genome import PackedChromosome, tile_words_for
from subphaser_torch.kernels import KernelError
from subphaser_torch.ops.kmer import SENTINEL, forward_codes, kmer_codes

HASH_MUL = 2654435761
MAX_CAP = 1 << 24  # the cap retries of a tile stop here

launches = {"sampled_anchors": 0, "match_emit": 0}
entry_launches = {"an_sampled_anchors": 0, "an_match_scan": 0, "an_match_emit": 0}
_launch_lock = threading.Lock()
_lib = None


def anchors_lib():
    """csrc/anchors.cu (both kernels), built at first use."""
    global _lib
    with _launch_lock:
        if _lib is None:
            import ctypes

            from subphaser_torch import kernels

            lib = kernels.load("anchors")
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.an_sampled_anchors.argtypes = [ptr, ptr, i32, i32, ctypes.c_ulonglong, i32,
                                               ptr, ptr, ptr, ptr, ptr, ptr]
            lib.an_sample_scratch_size.argtypes = [i32]
            lib.an_sample_scratch_size.restype = ctypes.c_longlong
            lib.an_match_scratch_size.argtypes = [i32]
            lib.an_match_scratch_size.restype = ctypes.c_longlong
            lib.an_match_scan.argtypes = [ptr] * 6 + [i32, i32, ptr, ptr, ptr]
            lib.an_match_emit.argtypes = [ptr, ptr, i32, ptr, i32, i32] + [ptr] * 4
            lib.an_error_string.argtypes = [i32]
            for fn in (lib.an_sampled_anchors, lib.an_match_scan, lib.an_match_emit):
                fn.restype = i32
            lib.an_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _check(lib, err: int, entry: str) -> None:
    if err != 0:
        raise KernelError(f"{entry} launch failed: " + lib.an_error_string(err).decode())
    with _launch_lock:
        entry_launches[entry] += 1


def _count_launch(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on a 16-byte boundary (kernel B reads
    the query side by 16-byte loads); a view that does not is copied."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _threshold(mod: int) -> int:
    return (1 << 32) // mod


def sampled_anchors_plain(words, vwords, *, k: int, n_pos_words: int, mod: int, cap: int):
    """The plain version of :func:`sampled_anchors`, as the JAX function
    computes it: the hash is a uint32 product, here in int64 masked to 32
    bits."""
    canon = kmer_codes(words, vwords, k, n_pos_words)   # (16, W)
    fwd = forward_codes(words, vwords, k, n_pos_words)
    strand = (canon != fwd).to(torch.int32)
    p = torch.arange(16, dtype=torch.int32, device=canon.device)[:, None]
    w = torch.arange(n_pos_words, dtype=torch.int32, device=canon.device)[None, :]
    pos = (w * 16 + p).reshape(-1)
    h = (canon.to(torch.int64) * HASH_MUL) & 0xFFFFFFFF
    take = ((canon != SENTINEL) & (h < _threshold(mod))).reshape(-1)
    idx = torch.nonzero(take).squeeze(1)
    n_total = torch.tensor(idx.numel(), dtype=torch.int32, device=canon.device)
    idx = idx[:cap]
    n = idx.numel()
    out_c = torch.full((cap,), SENTINEL, dtype=torch.int32, device=canon.device)
    out_p = torch.full((cap,), -1, dtype=torch.int32, device=canon.device)
    out_s = torch.zeros(cap, dtype=torch.int32, device=canon.device)
    out_c[:n] = canon.reshape(-1)[idx]
    out_p[:n] = pos[idx]
    out_s[:n] = strand.reshape(-1)[idx]
    return out_c, out_p, out_s, n_total


def sampled_anchors(words, vwords, *, k: int, n_pos_words: int, mod: int, cap: int):
    """(codes, pos, strand) of sampled canonical k-mers, SENTINEL padded,
    and the number sampled before the cap (a 0-d int32 tensor).

    strand: 0 where the forward code is the canonical one, 1 where the
    reverse complement is. pos is tile-local. Sampling is a
    multiplicative-hash threshold (density exactly 1/mod, deterministic per
    code so both sequences pick the same k-mers); the order is the JAX
    arrays' offset-major order (flat index p * n_pos_words + w for the k-mer
    at base w * 16 + p), which the truncation at ``cap`` follows.

    A CUDA tensor launches kernel A of csrc/anchors.cu (a count pass and a
    write pass, two launches); a CPU tensor takes
    :func:`sampled_anchors_plain`."""
    if words.dtype != torch.int32 or vwords.dtype != torch.int32 or words.dim() != 1:
        raise ValueError("sampled_anchors: words and vwords must be 1-D int32")
    if words.shape != vwords.shape or words.device != vwords.device:
        raise ValueError("sampled_anchors: words and vwords must match in shape and device")
    if not 1 <= k <= 15 or n_pos_words < 1 or words.numel() < n_pos_words + 1:
        raise ValueError(f"sampled_anchors: k={k}, n_pos_words={n_pos_words} for "
                         f"{words.numel()} words")
    if mod < 1 or cap < 1:
        raise ValueError(f"sampled_anchors: mod={mod}, cap={cap}")
    if words.device.type == "cpu":
        return sampled_anchors_plain(words, vwords, k=k, n_pos_words=n_pos_words, mod=mod,
                                     cap=cap)
    if words.device.type != "cuda":
        raise ValueError(f"sampled_anchors: unsupported device {words.device}")
    if 16 * n_pos_words >= 1 << 31:
        raise ValueError("sampled_anchors: a tile holds fewer than 2^31 positions")
    dev = words.device
    out = [torch.empty(cap, dtype=torch.int32, device=dev) for _ in range(3)]
    n_total = torch.empty((), dtype=torch.int32, device=dev)
    lib = anchors_lib()
    scratch = torch.empty(lib.an_sample_scratch_size(n_pos_words), dtype=torch.int32,
                          device=dev)
    w, v = words.contiguous(), vwords.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.an_sampled_anchors(w.data_ptr(), v.data_ptr(), k, n_pos_words,
                                     _threshold(mod), cap, *(o.data_ptr() for o in out),
                                     n_total.data_ptr(), scratch.data_ptr(), stream)
    _check(lib, err, "an_sampled_anchors")
    _count_launch("sampled_anchors")
    return out[0], out[1], out[2], n_total


def _tile_words(chrom: PackedChromosome, start: int, n_words: int):
    """A tile's (words, vwords), zero past the chromosome's end; None when
    the tile starts past it."""
    w0 = start // 16
    avail = min(n_words, chrom.packed.shape[0] - w0)
    if avail <= 0:
        return None
    words = np.zeros(n_words, dtype=np.int32)
    vwords = np.zeros(n_words, dtype=np.int32)
    words[:avail] = chrom.packed[w0 : w0 + avail]
    vwords[:avail] = chrom.vmask[w0 : w0 + avail]
    return words, vwords


def _base_cap(tile_bases: int, mod: int) -> int:
    # expected anchors ~= tile/mod
    return max(tile_bases // mod * 2, 1 << 12)


def _tile_anchors(chrom: PackedChromosome, start: int, k: int, mod: int, tile_bases: int,
                  device: torch.device):
    """One tile's sampled anchors on ``device``, positions made
    chromosome-wide, the cap raised 4x a try (up to MAX_CAP) until it holds
    them: (c, p, s, n, cap), or None past the chromosome's end."""
    tw = _tile_words(chrom, start, tile_words_for(tile_bases, k))
    if tw is None:
        return None
    words, vwords = (torch.from_numpy(a).to(device) for a in tw)
    cap = _base_cap(tile_bases, mod)
    while True:
        c, p, s, n_total = sampled_anchors(words, vwords, k=k, n_pos_words=tile_bases // 16,
                                           mod=mod, cap=cap)
        n = int(n_total)
        if n <= cap or cap >= MAX_CAP:
            break
        cap *= 4
    p = torch.where(p >= 0, p + start, -1)
    return c, p, s, n, cap


class DevAnchors:
    """A chromosome's sampled anchors, resident on device.

    ``c``/``p``/``s`` are position-ordered and compacted (no pads).
    ``sorted3()`` lazily computes and memoizes the code-sorted copy — each
    chromosome participates in every pair of its homoeologous set, so the
    t-side sort (and the q-side occurrence lookup) is paid once per
    chromosome, not once per pair.

    Iterable as (c, p, s, n)."""

    __slots__ = ("c", "p", "s", "n", "_sorted", "_occ")

    def __init__(self, c, p, s, n: int):
        self.c, self.p, self.s, self.n = c, p, s, n
        self._sorted = None
        self._occ = None

    def __iter__(self):
        return iter((self.c, self.p, self.s, self.n))

    def __getitem__(self, i):
        return (self.c, self.p, self.s, self.n)[i]

    def sorted3(self):
        if self._sorted is None:
            self._sorted = _sort3(self.c, self.p, self.s)
        return self._sorted

    def occ(self):
        """Per-anchor occurrence count of its code within this chromosome
        (cached: q_occ depends only on the q side, so it is paid once per
        chromosome, not once per pair)."""
        if self._occ is None:
            lo, hi = _ss_left_right(self.sorted3()[0], self.c)
            self._occ = hi - lo
        return self._occ


def _sort3(c, p, s):
    """(c, p, s) sorted by code, stably (jax.lax.sort's default)."""
    cs, order = torch.sort(c, stable=True)
    return cs, p[order], s[order]


def chrom_anchors_dev(
    chrom: PackedChromosome, k: int = 15, mod: int = 16,
    tile_bases: int = 1 << 23, device=None,
) -> DevAnchors:
    """Sampled anchors for a whole chromosome, kept on ``device`` (CUDA
    unless the caller asks for the CPU): a :class:`DevAnchors` in position
    order, each tile's valid prefix (no pads). Feeds
    :func:`match_anchors_dev`, which joins two sides on the device so only
    matched pairs come to the host."""
    device = resolve_device(device)
    parts_c, parts_p, parts_s = [], [], []
    for start in range(0, chrom.length, tile_bases):
        got = _tile_anchors(chrom, start, k, mod, tile_bases, device)
        if got is None:
            continue
        c, p, s, n, cap = got
        n = min(n, cap)
        parts_c.append(c[:n])
        parts_p.append(p[:n])
        parts_s.append(s[:n])
    if not parts_c:
        z = torch.full((1,), SENTINEL, dtype=torch.int32, device=device)
        return DevAnchors(z, torch.full((1,), -1, dtype=torch.int32, device=device),
                          torch.zeros(1, dtype=torch.int32, device=device), 0)
    c, p, s = (torch.cat(xs) for xs in (parts_c, parts_p, parts_s))
    return DevAnchors(c, p, s, c.numel())


def _ss_left_right(keys, queries):
    """Left and right insertion ranks (int32) of ``queries`` in sorted
    ``keys``."""
    return (
        torch.searchsorted(keys, queries, out_int32=True),
        torch.searchsorted(keys, queries, right=True, out_int32=True),
    )


def match_emit_plain(qc, q_occ, qp, qs, tp_s, ts_s, lo, hi, *, max_occ: int):
    """The plain version of :func:`match_emit`: the keep rule of the JAX
    ``_combine_runs`` and the pairs ``_match_emit`` emits, in its csum
    order."""
    runs = hi - lo
    keep = (runs > 0) & (runs <= max_occ) & (q_occ <= max_occ) & (qc != SENTINEL)
    lens = torch.where(keep, runs, torch.zeros_like(runs)).to(torch.int64)
    qi = torch.repeat_interleave(torch.arange(qc.numel(), device=qc.device), lens)
    first = torch.cumsum(lens, 0) - lens
    tj = lo.to(torch.int64)[qi] + torch.arange(qi.numel(), device=qc.device) - first[qi]
    return qp[qi], tp_s[tj], (qs[qi] != ts_s[tj]).to(torch.int32)


def match_emit(qc, q_occ, qp, qs, tp_s, ts_s, lo, hi, *, max_occ: int):
    """Every (qpos, tpos, rel) pair of the kept runs, int32 each: query
    anchor i (codes ``qc``, occurrence counts in its own chromosome
    ``q_occ``, positions ``qp``, strands ``qs``) is kept when its run
    [lo[i], hi[i]) in the target's code-sorted anchors (``tp_s``, ``ts_s``)
    is 1..max_occ long, its own count is at most max_occ and it is not a
    pad; it pairs with every target of its run, rel = (qs != ts), in query
    order and run order.

    A CUDA tensor launches kernel B of csrc/anchors.cu (a scan that
    compacts the kept queries, then, once the host has read the number of
    pairs, the emit); a CPU tensor takes :func:`match_emit_plain`."""
    q_side, t_side = (qc, q_occ, qp, qs, lo, hi), (tp_s, ts_s)
    n = qc.numel()
    for x in q_side + t_side:
        if x.dtype != torch.int32 or x.dim() != 1 or x.device != qc.device:
            raise ValueError("match_emit: the inputs must be 1-D int32 on one device")
    if any(x.numel() != n for x in q_side) or tp_s.numel() != ts_s.numel():
        raise ValueError("match_emit: the query side and the target side must each "
                         "have one length")
    if max_occ < 1:
        raise ValueError(f"match_emit: max_occ={max_occ}")
    if qc.device.type == "cpu":
        return match_emit_plain(qc, q_occ, qp, qs, tp_s, ts_s, lo, hi, max_occ=max_occ)
    if qc.device.type != "cuda":
        raise ValueError(f"match_emit: unsupported device {qc.device}")
    dev = qc.device
    if n == 0:
        return tuple(torch.empty(0, dtype=torch.int32, device=dev) for _ in range(3))
    if n * max_occ >= 1 << 31:
        raise ValueError("match_emit: the pairs must number fewer than 2^31")
    lib = anchors_lib()
    qc, q_occ, lo, hi = (_aligned(x) for x in (qc, q_occ, lo, hi))
    qp, qs, tp_s, ts_s = (x.contiguous() for x in (qp, qs, tp_s, ts_s))
    scratch = torch.empty(lib.an_match_scratch_size(n), dtype=torch.int32, device=dev)
    totals = torch.empty(2, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.an_match_scan(*(x.data_ptr() for x in (qc, q_occ, lo, hi, qp, qs)), n,
                                max_occ, totals.data_ptr(), scratch.data_ptr(), stream)
        _check(lib, err, "an_match_scan")
        n_pairs, n_kept = totals.tolist()
        out = [torch.empty(n_pairs, dtype=torch.int32, device=dev) for _ in range(3)]
        if n_pairs:
            err = lib.an_match_emit(tp_s.data_ptr(), ts_s.data_ptr(), n, scratch.data_ptr(),
                                    n_kept, n_pairs, *(o.data_ptr() for o in out), stream)
            _check(lib, err, "an_match_emit")
    _count_launch("match_emit")
    return tuple(out)


def match_anchors_dev(qa: DevAnchors, ta: DevAnchors, max_occ: int = 8):
    """Join device anchor sets -> host (qpos int64, tpos int64, rel int32),
    (q, t)-sorted.

    ``qa``/``ta`` are :func:`chrom_anchors_dev` results on one device. The
    pairs are every (query, target) pair of equal codes that the keep rule
    of :func:`match_emit` keeps; the order is (qpos, tpos) ascending. The target's code-sorted anchors and the
    query's occurrence counts are cached on the DevAnchors, so a
    homoeologous set pays them once per chromosome."""
    q_occ = qa.occ()
    tc_s, tp_s, ts_s = ta.sorted3()
    lo, hi = _ss_left_right(tc_s, qa.c)
    q, t, r = (x.cpu().numpy() for x in match_emit(qa.c, q_occ, qa.p, qa.s, tp_s, ts_s, lo,
                                                   hi, max_occ=max_occ))
    t = t.astype(np.int64)
    order = np.lexsort((t, q))
    return q[order].astype(np.int64), t[order], r[order]
