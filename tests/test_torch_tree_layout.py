"""PyTorch port: the index arithmetic of the LTR trees' kernels
(csrc/tree_counts.cu) checked on the CPU.

The kernels run only on the card. What is checked here is a numpy
transcription of their indexing, with the constants read from the .cu.
``match_counts``' bits route: the host's expansion index (column c repeated
w_c times), ``pack_planes_kernel``'s warp a (row, word) and its ballots
(five code planes, a byte above 20 on the spare code, valid, letter, a zero
word; GAP past the expanded columns), ``bit_counts_kernel``'s 1-D grid of
upper BT_TILE x BT_TILE tiles, its staging of KW words of the tile's rows
into BT_PITCH-word rows of shared memory, its KGROUPS groups on every
KGROUPS-th word, each thread's BT_PAIRS x BT_PAIRS interleaved pairs and
their popcount sums, and the groups' partial tiles summed in shared memory
to coalesced stores with the mirror. Its float route
(``match_counts_kernel``): its grid of 64 x 64 pair tiles (upper tiles
only, each writing its mirror), its staging of CHUNK columns of the tile's
rows column-major into a PITCH-byte row of shared memory, each thread's
4-byte read of its PAIRS rows and the byte unpack, the ragged last tile and
chunk (GAP rows, zero weights). ``inter_counts_kernel``'s pair-to-warp map
and lane split of the sketch (lane l takes values l, l + 32, ...), its
lower-bound search clamped to s - 1 and the warp's sum. Each transcription
is held exact to the plain versions (``match_counts_plain``,
``inter_counts_plain``) at n not a multiple of the tile, L (or the sum of
the weights) not a multiple of the chunk (or of 32), weights with zeros and
counts above 1, and s other than 256; a transcription with one index
broken must disagree.
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
BITS_NAMES = ("EXPANDED_LIMIT", "SPARE", "PLANES", "PACK_WARPS", "BT_TILE", "BT_PAIRS", "BT_SIDE",
              "BT_GROUP", "KGROUPS", "BT_THREADS", "KW", "BT_PITCH", "OUT_PITCH")
for _name in BITS_NAMES:
    CONST[_name] = _const(_name)
(EXPANDED_LIMIT, SPARE, PLANES, PACK_WARPS, BT_TILE, BT_PAIRS, BT_SIDE, BT_GROUP, KGROUPS,
 BT_THREADS, KW, BT_PITCH, OUT_PITCH) = (CONST[n] for n in BITS_NAMES)


def test_constants():
    assert GAP == tm.GAP
    assert SIDE * PAIRS == TILE and THREADS == SIDE * SIDE
    assert PITCH % 4 == 0 and PITCH >= TILE  # a thread's 4 rows are one aligned word
    assert (PITCH // 4) % 2 == 1  # an odd word pitch: column-wise stores spread over banks


def test_bits_constants():
    assert EXPANDED_LIMIT == tm.EXPANDED_LIMIT and PLANES == tm.PLANES
    assert EXPANDED_LIMIT <= 1 << 24  # int32 sums converted to float32 exactly
    assert GAP < SPARE < 32 and PLANES >= 7 and PLANES % 4 == 0  # two 16-byte reads a word
    assert BT_SIDE * BT_PAIRS == BT_TILE and BT_GROUP == BT_SIDE ** 2
    assert BT_THREADS == BT_GROUP * KGROUPS and BT_GROUP % 32 == 0  # a group is whole warps
    assert BT_PITCH % 4 == 0 and BT_PITCH >= KW * PLANES and BT_PITCH % 32 == 4
    assert 2 * BT_TILE * BT_PITCH * 4 <= 48 * 1024  # static shared memory
    assert KGROUPS * 2 * BT_TILE * OUT_PITCH <= 2 * BT_TILE * BT_PITCH  # the partial tiles fit


def test_bits_shared_memory_banks():
    """A warp's 16-byte reads of its i-rows (4 distinct) and of its j-rows
    (8 distinct) fall on distinct banks, and so do each quarter warp's
    16-byte staging stores."""
    for warp in range(BT_THREADS // 32):
        gt = np.arange(warp * 32, warp * 32 + 32) % BT_GROUP
        ty, tx = gt // BT_SIDE, gt % BT_SIDE
        for p in range(BT_PAIRS):
            for rows in (ty + BT_SIDE * p, BT_TILE + tx + BT_SIDE * p):
                starts = {int(r) * BT_PITCH for r in rows}
                banks = [(s + b) % 32 for s in starts for b in range(4)]
                assert len(banks) == len(set(banks))
    for e0 in range(0, 2 * BT_TILE * KW * 2, 8):  # a quarter warp's 16-byte stores
        e = np.arange(e0, e0 + 8)
        r, w, h = e // (2 * KW), (e // 2) % KW, e % 2
        banks = (r * BT_PITCH + w * PLANES + h * 4) % 32
        assert len(set(banks)) == 8


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


def pack_planes_emulated(aln: np.ndarray, idx: np.ndarray, broken: str = "") -> np.ndarray:
    """pack_planes_kernel: (n, NW, PLANES) uint32; warp u of the grid
    (block u / PACK_WARPS) on unit u = row * NW + word, lane l on expanded
    column word * 32 + l, one ballot a plane."""
    n, _length = aln.shape
    lx = idx.size
    nw = -(-lx // 32)
    blocks = -(-(n * nw) // PACK_WARPS)
    unit = np.arange(blocks * PACK_WARPS)
    unit = unit[unit < n * nw]  # the warps past the last unit return
    row, c = unit // nw, (unit % nw)[:, None] * 32 + np.arange(32)[None, :]
    pad = GAP if broken != "pads_valid" else 0
    b = np.full(c.shape, pad, np.uint32)
    ok = c < lx
    b[ok] = aln[np.broadcast_to(row[:, None], c.shape)[ok], idx[c[ok]]]
    code = np.where(b <= GAP, b, SPARE).astype(np.uint32)
    bit = np.uint32(1) << np.arange(32, dtype=np.uint32)

    def ballot(pred):
        return (pred.astype(np.uint32) * bit).sum(axis=-1, dtype=np.uint64).astype(np.uint32)

    planes = np.zeros((n * nw, PLANES), np.uint32)
    for q in range(5):
        planes[unit, q] = ballot((code >> q) & 1)
    planes[unit, 5] = ballot(b != GAP)
    planes[unit, 6] = ballot(b < GAP)
    return planes.reshape(n, nw, PLANES)


def bit_counts_emulated(planes: np.ndarray, n: int, broken: str = "") -> tuple:
    """bit_counts_kernel: every block of the 1-D grid of upper tiles, its
    staged chunks of KW words, each group's words and each thread's pairs,
    the sum of the groups' partial tiles and the stores."""
    nw = planes.shape[1]
    T = -(-n // BT_TILE)
    V = np.full((n, n), np.nan, np.float32)
    M = np.full((n, n), np.nan, np.float32)
    gt = np.arange(BT_GROUP)
    ty, tx = gt // BT_SIDE, gt % BT_SIDE
    rows_i = ty[:, None] + BT_SIDE * np.arange(BT_PAIRS)[None, :]  # (threads, PAIRS)
    rows_j = BT_TILE + tx[:, None] + BT_SIDE * np.arange(BT_PAIRS)[None, :]
    flat = planes.reshape(-1)
    stride = KGROUPS - 1 if broken == "group_stride" else KGROUPS
    for blk in range(T * (T + 1) // 2):
        ti, rem = 0, blk
        while rem > T - ti if broken == "tile_map" else rem >= T - ti:
            rem -= T - ti
            ti += 1
        tj = ti + rem
        i0, j0 = ti * BT_TILE, (ti if broken == "j_rows_from_i" else tj) * BT_TILE
        v = np.zeros((KGROUPS, BT_GROUP, BT_PAIRS, BT_PAIRS), np.int64)
        m = np.zeros_like(v)
        for c0 in range(0, nw, KW):
            kw = min(KW, nw - c0)
            s = np.zeros(2 * BT_TILE * BT_PITCH, np.uint32)
            e = np.arange(2 * BT_TILE * KW * 2)
            r, w, h = e // (2 * KW), (e // 2) % KW, e % 2
            row = np.where(r < BT_TILE, i0 + r, j0 + r - BT_TILE)
            ok = (row < n) & (w < kw)
            for x in range(4):  # the uint4's words
                src = ((row * nw + c0 + w) * PLANES + h * 4 + x)[ok]
                s[(r * BT_PITCH + w * PLANES + h * 4 + x)[ok]] = flat[src]
            s = s.reshape(2 * BT_TILE, BT_PITCH)
            for g in range(KGROUPS):
                for w in range(g, kw, stride):
                    a = s[rows_i, w * PLANES:(w + 1) * PLANES][:, :, None, :]  # (thr, P, 1, 8)
                    b = s[rows_j, w * PLANES:(w + 1) * PLANES][:, None, :, :]  # (thr, 1, Q, 8)
                    d = np.bitwise_or.reduce(a[..., :5] ^ b[..., :5], axis=-1)
                    m[g] += np.bitwise_count(a[..., 6] & ~d)
                    v[g] += np.bitwise_count(a[..., 5] & b[..., 5])
        part = np.zeros((KGROUPS, 2, BT_TILE, OUT_PITCH), np.int64)
        for p in range(BT_PAIRS):
            for q in range(BT_PAIRS):
                part[:, 0, ty + BT_SIDE * p, tx + BT_SIDE * q] = v[:, :, p, q]
                part[:, 1, ty + BT_SIDE * p, tx + BT_SIDE * q] = m[:, :, p, q]
        tile = part.sum(axis=0).astype(np.float32)  # (2, BT_TILE, OUT_PITCH)
        e = np.arange(BT_TILE * BT_TILE)
        r, c = e // BT_TILE, e % BT_TILE
        ok = (i0 + r < n) & (j0 + c < n)
        V[(i0 + r)[ok], (j0 + c)[ok]] = tile[0, r[ok], c[ok]]
        M[(i0 + r)[ok], (j0 + c)[ok]] = tile[1, r[ok], c[ok]]
        if ti != tj:
            ok = (j0 + r < n) & (i0 + c < n)
            rr, cc = (r, c) if broken == "mirror_unswapped" else (c, r)
            V[(j0 + r)[ok], (i0 + c)[ok]] = tile[0, rr[ok], cc[ok]]
            M[(j0 + r)[ok], (i0 + c)[ok]] = tile[1, rr[ok], cc[ok]]
    return V, M


def bits_route_emulated(aln: np.ndarray, w: np.ndarray, broken: str = "") -> tuple:
    idx = tm.expansion_index(w)
    return bit_counts_emulated(pack_planes_emulated(aln, idx, broken), aln.shape[0], broken)


def _bits_case(n: int, length: int, weights: str, seed: int):
    """An alignment with gap-rich rows, an all-gap column and bytes above
    20, and integer weights: ones, a multinomial draw, or bursty counts
    with zeros."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 21, size=(n, length)).astype(np.uint8)
    a[: n // 4, : length // 3] = GAP
    a[:, length // 2] = GAP
    a[rng.random((n, length)) < 0.03] = rng.integers(21, 256)
    if weights == "ones":
        w = np.ones(length, np.float32)
    elif weights == "multinomial":
        w = rng.multinomial(length, np.full(length, 1.0 / length)).astype(np.float32)
    else:
        w = np.where(rng.random(length) < 0.4, 0, rng.integers(1, 9, length)).astype(np.float32)
    return a, w


@pytest.mark.parametrize("n,length,weights", [
    (1, 1, "ones"), (33, 70, "multinomial"), (70, 129, "multinomial"), (65, 40, "bursty"),
    (40, 300, "bursty"),  # more than KW words: two staged chunks
    (31, 31, "ones"),
])
def test_bits_route_schedule_equals_plain(n, length, weights):
    a, w = _bits_case(n, length, weights, n * 1000 + length)
    V, M = bits_route_emulated(a, w)
    pv, pm = tm.match_counts_plain(torch.from_numpy(a), torch.from_numpy(w))
    assert np.array_equal(V, pv.numpy()) and np.array_equal(M, pm.numpy())


@pytest.mark.parametrize("broken", ["pads_valid", "tile_map", "j_rows_from_i",
                                    "mirror_unswapped", "group_stride"])
def test_bits_route_schedule_with_a_broken_index_disagrees(broken):
    a, w = _bits_case(70, 129, "bursty", 11)
    V, M = bits_route_emulated(a, w, broken)
    pv, pm = tm.match_counts_plain(torch.from_numpy(a), torch.from_numpy(w))
    assert not (np.array_equal(V, pv.numpy()) and np.array_equal(M, pm.numpy()))


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
