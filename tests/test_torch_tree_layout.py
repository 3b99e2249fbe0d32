"""PyTorch port: the index arithmetic of the LTR trees' kernels
(csrc/tree_counts.cu) checked on the CPU.

The kernels run only on the card. What is checked here is a numpy
transcription of their indexing, with the constants read from the .cu:
``match_counts_kernel``'s grid of 64 x 64 pair tiles (upper tiles only,
each writing its mirror), its staging of CHUNK columns of the tile's rows
column-major into a PITCH-byte row of shared memory, each thread's 4-byte
read of its PAIRS rows and the byte unpack, the ragged last tile and chunk
(GAP rows, zero weights); and ``inter_counts_kernel``'s pair-to-warp map
and lane split of the sketch (lane l takes values l, l + 32, ...), its
lower-bound search clamped to s - 1 and the warp's sum. Each transcription
is held exact to the plain versions (``match_counts_plain``,
``inter_counts_plain``) at n not a multiple of the tile, L not a multiple
of the chunk and s other than 256; a transcription with one index broken
must disagree.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from subphaser_torch.ltr import msa as tm
from subphaser_torch.ltr import tree as tt
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SRC = Path(__file__).resolve().parents[1] / "subphaser_torch" / "csrc" / "tree_counts.cu"
TEXT = SRC.read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = ([^;]+);", TEXT)
    assert m, name
    return int(eval(m.group(1), {}, CONST))  # noqa: S307 (the .cu's own constants)


CONST: dict[str, int] = {}
for _name in ("GAP", "TILE", "CHUNK", "PAIRS", "SIDE", "THREADS", "PITCH", "IC_WARPS"):
    CONST[_name] = _const(_name)
GAP, TILE, CHUNK, PAIRS, SIDE, THREADS, PITCH, IC_WARPS = CONST.values()


def test_constants():
    assert GAP == tm.GAP
    assert SIDE * PAIRS == TILE and THREADS == SIDE * SIDE
    assert PITCH % 4 == 0 and PITCH >= TILE  # a thread's 4 rows are one aligned word
    assert (PITCH // 4) % 2 == 1  # an odd word pitch: column-wise stores spread over banks


def test_shared_memory_banks():
    """The staging stores of a warp (one row, 32 consecutive columns) hit 32
    banks; a warp's reads of a column touch at most 2 words of the i-side
    (broadcast) and distinct banks for its distinct j-side words."""
    for e0 in range(0, TILE * CHUNK, 32):
        banks = {((e % CHUNK) * PITCH + e // CHUNK) // 4 % 32 for e in range(e0, e0 + 32)}
        assert len(banks) == 32
    for warp in range(THREADS // 32):
        tids = np.arange(warp * 32, warp * 32 + 32)
        for c in (0, 1, CHUNK - 1):
            a_words = {(c * PITCH + t // SIDE * PAIRS) // 4 for t in tids}
            b_words = {(c * PITCH + t % SIDE * PAIRS) // 4 for t in tids}
            assert len(a_words) <= 2
            assert len({w % 32 for w in b_words}) == len(b_words)


def match_counts_emulated(aln: np.ndarray, w: np.ndarray, broken: str = "") -> tuple:
    """match_counts_kernel's schedule in numpy: every block of the grid,
    its staged chunks and each thread's pairs."""
    n, length = aln.shape
    V = np.full((n, n), np.nan, np.float32)
    M = np.full((n, n), np.nan, np.float32)
    tiles = -(-n // TILE)
    tid = np.arange(THREADS)
    tx, ty = tid % SIDE, tid // SIDE
    for ti in range(tiles):
        for tj in range(tiles):
            if tj < ti:  # mirrored by tile (tj, ti)
                continue
            i0, j0 = ti * TILE, tj * TILE
            v = np.zeros((THREADS, PAIRS, PAIRS), np.float32)
            m = np.zeros((THREADS, PAIRS, PAIRS), np.float32)
            for c0 in range(0, length, CHUNK):
                sa = np.zeros((CHUNK, PITCH), np.uint8)
                sb = np.zeros((CHUNK, PITCH), np.uint8)
                for e in range(TILE * CHUNK):
                    r, c = e // CHUNK, e % CHUNK
                    col = c0 + c
                    x = y = GAP
                    if col < length:
                        if i0 + r < n:
                            x = aln[i0 + r, col]
                        if j0 + r < n:
                            y = aln[j0 + r, col]
                    if broken == "row_major":  # staged row-major, read column-major
                        sa[r, c], sb[r, c] = x, y
                    else:
                        sa[c, r], sb[c, r] = x, y
                sw = np.array([w[c0 + t] if c0 + t < length else 0.0 for t in range(CHUNK)],
                              np.float32)
                words_a = sa.view("<u4")  # (CHUNK, PITCH / 4): little-endian, as on the card
                words_b = sb.view("<u4")
                for c in range(min(CHUNK, length - c0)):
                    a4 = words_a[c, ty * PAIRS // 4].astype(np.uint32)
                    b4 = words_b[c, tx * PAIRS // 4].astype(np.uint32)
                    for p in range(PAIRS):
                        shift = 8 * (PAIRS - 1 - p) if broken == "byte_order" else 8 * p
                        a = (a4 >> shift) & 0xFF
                        for q in range(PAIRS):
                            b = (b4 >> (8 * q)) & 0xFF
                            both = (a != GAP) & (b != GAP)
                            same = (a < GAP) & (a == b)
                            v[:, p, q] += np.where(both, sw[c], np.float32(0))
                            m[:, p, q] += np.where(same, sw[c], np.float32(0))
            for p in range(PAIRS):
                for q in range(PAIRS):
                    i = i0 + ty * PAIRS + p
                    j = j0 + tx * PAIRS + q
                    ok = (i < n) & (j < n)
                    V[i[ok], j[ok]] = v[ok, p, q]
                    M[i[ok], j[ok]] = m[ok, p, q]
                    if broken != "no_mirror":
                        V[j[ok], i[ok]] = v[ok, p, q]
                        M[j[ok], i[ok]] = m[ok, p, q]
    return V, M


def _alignment(n: int, length: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 21, size=(n, length)).astype(np.uint8)
    a[: n // 4, : length // 3] = GAP
    a[:, length // 2] = GAP
    w = rng.multinomial(length, np.full(length, 1.0 / length)).astype(np.float32)
    return a, w


@pytest.mark.parametrize("n,length", [(1, 1), (5, 64), (65, 70), (130, 129)])
def test_match_counts_schedule_equals_plain(n, length):
    a, w = _alignment(n, length, n + length)
    V, M = match_counts_emulated(a, w)
    pv, pm = tm.match_counts_plain(torch.from_numpy(a), torch.from_numpy(w))
    assert np.array_equal(V, pv.numpy()) and np.array_equal(M, pm.numpy())


@pytest.mark.parametrize("broken", ["row_major", "byte_order", "no_mirror"])
def test_match_counts_schedule_with_a_broken_index_disagrees(broken):
    a, w = _alignment(70, 70, 3)
    V, M = match_counts_emulated(a, w, broken)
    pv, pm = tm.match_counts_plain(torch.from_numpy(a), torch.from_numpy(w))
    assert not (np.array_equal(V, pv.numpy()) and np.array_equal(M, pm.numpy()))


def inter_counts_emulated(pad: np.ndarray, ai: np.ndarray, bi: np.ndarray,
                          broken: str = "") -> np.ndarray:
    """inter_counts_kernel in numpy: block b's warp k takes pair
    b * IC_WARPS + k; lane l searches values l, l + 32, ... of row ai."""
    n_pairs, s = ai.size, pad.shape[1]
    out = np.full(n_pairs, -1, np.int64)
    big = np.iinfo(np.int32).max
    for blk in range(-(-n_pairs // IC_WARPS)):
        for warp in range(IC_WARPS):
            pair = blk * IC_WARPS + warp
            if pair >= n_pairs:
                continue
            arow, brow = pad[ai[pair]], pad[bi[pair]].copy()  # brow: the warp's shared copy
            total = 0
            for lane in range(32):
                for t in range(lane, s, 32):
                    a = arow[t]
                    lo, hi = 0, s
                    while lo < hi:
                        mid = (lo + hi) >> 1
                        if brow[mid] < a if broken != "upper" else brow[mid] <= a:
                            lo = mid + 1
                        else:
                            hi = mid
                    pos = min(lo, s - 1)
                    total += int(brow[pos] == a and a != big)
            out[pair] = total
    return out


def _pads(n: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 1 << 31, size=3 * s, dtype=np.int64)
    pad = np.full((n, s), np.iinfo(np.int32).max, np.int32)
    for i in range(n):
        k = int(rng.integers(0, s + 1)) if i % 5 else s
        v = np.unique(rng.choice(pool, size=k, replace=False)).astype(np.int32)
        pad[i, : v.size] = v
    ai, bi = np.triu_indices(n, 1)
    return pad, ai, bi


@pytest.mark.parametrize("n,s", [(2, 1), (9, 37), (13, 100), (6, 256)])
def test_inter_counts_lanes_equal_plain(n, s):
    pad, ai, bi = _pads(n, s, n * s)
    want = tt.inter_counts_plain(torch.from_numpy(pad), torch.from_numpy(ai),
                                 torch.from_numpy(bi)).numpy()
    assert np.array_equal(inter_counts_emulated(pad, ai, bi), want)


def test_inter_counts_upper_bound_search_disagrees():
    """With an upper-bound search the clamped position misses values at the
    end of a full row."""
    pad, ai, bi = _pads(13, 100, 5)
    want = tt.inter_counts_plain(torch.from_numpy(pad), torch.from_numpy(ai),
                                 torch.from_numpy(bi)).numpy()
    assert not np.array_equal(inter_counts_emulated(pad, ai, bi, "upper"), want)
