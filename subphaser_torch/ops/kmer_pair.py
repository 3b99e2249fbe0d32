"""Canonical k-mer codes for k in [16, 31]: (hi, lo) int32 pair codes.

A 2k-bit code (up to 62 bits) is carried as two int32 words: ``lo`` = bits
[0, 31), ``hi`` = bits [31, 2k). Their int64 form is ``hi << 31 | lo``
(:func:`combine64`); the count and map modules sort and search that single
key on the device, and everything host-side (merges, matrices, matching,
k-mer strings) uses it too.

Same word-level scheme as ops/kmer.py: the k-mer window at position p spans
three packed words; the little-endian window value gives the reverse
complement by complement alone and the forward code by one 2-bit-group
reversal. The JAX package does this in uint32 with logical shifts; here
every word is an int64 holding its uint32 value, masked back to 32 bits
after each ``<<``, ``~`` and ``|`` (PyTorch's ``>>`` on int32 is arithmetic).

Padding is the PAIR (SENTINEL, SENTINEL), int64 ``PAD64 = 2^62 - 1``, which
sorts after every canonical code. At k = 31 the hi part holds 31 value
bits, so hi == SENTINEL is representable. For CANONICAL codes it can never
occur: hi all-ones needs the first 15 bases T and base 16 in {G, T};
canonicity (code <= rc) then forces rc to open with the same T-run, which
pins the last 15 bases to A and position 16 of rc to the COMPLEMENT of base
16 - complement(G/T) = C/A < G/T, contradiction. Counting's hi-only pad
tests therefore stay exact at k = 31. FORWARD codes (mapping) can reach
hi == SENTINEL legitimately, so mapping tests the whole pair; only a
position whose forward 31-mer is exactly T^31 is then indistinguishable
from padding and is skipped (poly-T 31-mers are never subgenome-specific).
"""

from __future__ import annotations

import numpy as np
import torch

from subphaser_torch.ops.kmer import BASES_PER_WORD, SENTINEL, _reverse2bits32

_U32 = 0xFFFFFFFF
_LO31 = 0x7FFFFFFF
PAD64 = (SENTINEL << 31) | SENTINEL  # the (SENTINEL, SENTINEL) pair as int64


def _codes64(words, vwords, k: int, n_pos_words: int, canonical: bool):
    """int64 codes ``hi << 31 | lo``, (16, n_pos_words), PAD64 where the
    k-mer touches an invalid base or runs past the tile."""
    if not 16 <= k <= 31:
        raise ValueError("pair codes support k in [16, 31]")
    w = words.to(torch.int64) & _U32
    v = vwords.to(torch.int64) & _U32
    w0, w1, w2 = (w[i : n_pos_words + i] for i in range(3))
    v0, v1, v2 = (v[i : n_pos_words + i] for i in range(3))

    bits = 2 * k
    hi_mask = (1 << (bits - 31)) - 1
    mask_hi_win = (1 << (bits - 32)) - 1  # window hi word: bits - 32 bits used
    vmask_k = (1 << k) - 1
    s = 64 - bits  # in [2, 32]

    def resplit(lo32, hi32):
        # 32/32 split -> 31/31 code split, combined: lo = bits [0, 31),
        # hi = bits [31, 2k)
        hi31 = ((lo32 >> 31) | ((hi32 << 1) & _U32)) & hi_mask
        return (hi31 << 31) | (lo32 & _LO31)

    out = torch.empty((BASES_PER_WORD, n_pos_words), dtype=torch.int64, device=w.device)
    for p in range(BASES_PER_WORD):
        if p == 0:
            vlo, vhi = w0, w1
        else:
            vlo = (w0 >> (2 * p)) | ((w1 << (32 - 2 * p)) & _U32)
            vhi = (w1 >> (2 * p)) | ((w2 << (32 - 2 * p)) & _U32)
        # little-endian window = vhi:vlo (64 bits); k-mer = bits [0, 2k).
        # forward big-endian = reverse the 2-bit groups of the 2k window
        # bits: reverse the full 64 (swap halves + rev32 each), >> (64-2k)
        r_hi = _reverse2bits32(vlo)  # high half of the reversed 64
        r_lo = _reverse2bits32(vhi)  # low half
        if s == 32:
            f_lo32, f_hi32 = r_hi, torch.zeros_like(r_hi)
        else:
            f_lo32 = (r_lo >> s) | ((r_hi << (32 - s)) & _U32)
            f_hi32 = (r_hi >> s) & mask_hi_win
        code = resplit(f_lo32, f_hi32)
        if canonical:
            # reverse complement, big-endian == complement of the window
            rc = resplit((~vlo) & _U32, (~vhi) & mask_hi_win)
            code = torch.minimum(code, rc)
        if p == 0:
            vv = (v0 | (v1 << 16)) & vmask_k
        else:
            vv = ((v0 >> p) | (v1 << (16 - p)) | (v2 << (32 - p))) & vmask_k
        out[p] = torch.where(vv == vmask_k, code, PAD64)
    return out


def kmer_codes64(words, vwords, k: int, n_pos_words: int) -> torch.Tensor:
    """Canonical codes as int64 (16, n_pos_words), PAD64 where invalid."""
    return _codes64(words, vwords, k, n_pos_words, canonical=True)


def forward_codes64(words, vwords, k: int, n_pos_words: int) -> torch.Tensor:
    return _codes64(words, vwords, k, n_pos_words, canonical=False)


def kmer_codes_pair(words, vwords, k: int, n_pos_words: int):
    """Canonical (hi, lo) codes, each (16, n_pos_words) int32."""
    return split64_t(kmer_codes64(words, vwords, k, n_pos_words))


def forward_codes_pair(words, vwords, k: int, n_pos_words: int):
    return split64_t(forward_codes64(words, vwords, k, n_pos_words))


# ---------------------------------------------------------------------------
# combine/split: tensors on the device, numpy on the host
# ---------------------------------------------------------------------------
def combine64_t(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int64) << 31) | lo.to(torch.int64)


def split64_t(code: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (code >> 31).to(torch.int32), (code & _LO31).to(torch.int32)


def combine64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (np.asarray(hi, dtype=np.int64) << 31) | np.asarray(lo, dtype=np.int64)


def split64(code: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    code = np.asarray(code, dtype=np.int64)
    return (code >> 31).astype(np.int32), (code & 0x7FFFFFFF).astype(np.int32)
