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
chunk (GAP rows, zero weights). ``inter_counts_kernel``'s runs of IC_RUN
pairs a warp and warps a block by the sketch width, its four slots
double-buffered (an a row staged once for the pairs of a run that share
it) and ending in INT32_MAX words, each lane's merge-path search of its
diagonal and its walk with no bound check, and the warp's sum. Each transcription is held exact to the plain versions
(``match_counts_plain``, ``inter_counts_plain``) at n not a multiple of the
tile, L (or the sum of the weights) not a multiple of the chunk (or of 32),
weights with zeros and counts above 1, s of 1, not a multiple of 32, 256
and 1536, and all-padding rows; a transcription with one index broken must
disagree.
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
for _name in ("GAP", "TILE", "CHUNK", "PAIRS", "SIDE", "THREADS", "PITCH"):
    CONST[_name] = _const(_name)
GAP, TILE, CHUNK, PAIRS, SIDE, THREADS, PITCH = CONST.values()
IC_NAMES = ("IC_WARPS", "IC_RUN", "IC_SLOTS", "IC_MAX_S", "IC_SMEM")
for _name in IC_NAMES:
    CONST[_name] = _const(_name)
IC_WARPS, IC_RUN, IC_SLOTS, IC_MAX_S, IC_SMEM = (CONST[n] for n in IC_NAMES)
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


def _ic_warps(s: int) -> int:
    """tc_inter_counts: warps a block at sketch width s."""
    return min(IC_WARPS, IC_SMEM // (IC_SLOTS * ic_slot_words(s) * 4))


def ic_slot_words(s: int) -> int:
    """A slot: the row, then at least ceil(2s / 32) + 1 INT32_MAX words,
    rounded to 16 bytes."""
    return (s + (2 * s + 31) // 32 + 1 + 3) & ~3


def test_inter_counts_constants():
    """Every width up to IC_MAX_S gets at least one warp a block within the
    shared memory; the path's s = 256 gets IC_WARPS; slots start on 16
    bytes (the 16-byte copies)."""
    assert _ic_warps(IC_MAX_S) >= 1 and _ic_warps(256) == IC_WARPS
    for s in (1, 37, 256, IC_MAX_S):
        assert _ic_warps(s) * IC_SLOTS * ic_slot_words(s) * 4 <= IC_SMEM
        assert ic_slot_words(s) % 4 == 0


def merge_count_emulated(a, b, s: int, lane: int, broken: str = "", reads=None) -> int:
    """ic_merge_count on one lane: the merge-path search of its first
    diagonal, then its walk over the slots (rows and INT32_MAX words)."""
    total = 2 * s
    per = (total + 31) // 32
    d0 = min(lane * per, total)
    d1 = min(d0 + per, total)
    lo, hi = max(0, d0 - s), min(d0, s)
    while lo < hi:
        mid = (lo + hi) >> 1
        if a[mid] <= b[d0 - (broken != "merge_start") - mid]:
            lo = mid + 1
        else:
            hi = mid
    i, j, count = lo, d0 - lo, 0
    big = np.iinfo(np.int32).max
    av, bv = a[i], b[j]
    for _d in range(d0, d1):  # no branch, no bound: past a row, INT32_MAX words
        take_a = av <= bv
        count += int(av == bv and av != big)
        i += take_a
        j += not take_a
        if reads is not None:
            reads.append(i if take_a else j)
        x = a[i] if take_a else b[j]  # the value that replaces the one taken
        av, bv = (x, bv) if take_a else (av, x)
    return count


def inter_counts_emulated(pad: np.ndarray, ai: np.ndarray, bi: np.ndarray,
                          broken: str = "", reads=None) -> tuple[np.ndarray, int]:
    """inter_counts_kernel in numpy: warp w of block blk takes the run of
    IC_RUN pairs from (blk * warps + w) * IC_RUN; its four slots (a rows in
    0 and 1, b rows in 2 and 3) are staged as the kernel stages them, pair
    k + 1's rows before pair k is counted. -> (counts, a rows staged); the
    slot words the walks read go to ``reads``."""
    n_pairs, s = ai.size, pad.shape[1]
    sw, warps = ic_slot_words(s), _ic_warps(s)
    out = np.full(n_pairs, -1, np.int64)
    staged_a = 0
    blocks = -(-(-(-n_pairs // IC_RUN)) // warps)
    for blk in range(blocks):
        for warp in range(warps):
            p0 = (blk * warps + warp) * IC_RUN
            if p0 >= n_pairs:
                continue
            n_run = min(IC_RUN, n_pairs - p0)
            slot = np.full((IC_SLOTS, sw), np.iinfo(np.int32).max, np.int64)
            slot[:, :s] = -5  # shared memory, unwritten; the INT32_MAX words set first

            def stage(k, row):
                slot[k, :s] = pad[row]

            cur_a = ai[p0]
            stage(0, cur_a)
            stage(2, bi[p0])
            staged_a += 1
            aslot = 0
            for k in range(n_run):
                next_aslot = aslot
                if k + 1 < n_run:
                    next_a = ai[p0 + k + 1]
                    if next_a != cur_a:
                        next_aslot = aslot if broken == "a_slot" else aslot ^ 1
                        stage(next_aslot, next_a)
                        staged_a += 1
                    stage(2 + ((k if broken == "b_slot" else k + 1) & 1), bi[p0 + k + 1])
                    cur_a = next_a
                a, b = slot[aslot], slot[2 + (k & 1)]
                out[p0 + k] = sum(merge_count_emulated(a, b, s, lane, broken, reads)
                                  for lane in range(32))
                aslot = next_aslot
    return out, staged_a


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


def _plain_counts(pad, ai, bi):
    return tt.inter_counts_plain(torch.from_numpy(pad), torch.from_numpy(ai),
                                 torch.from_numpy(bi)).numpy()


@pytest.mark.parametrize("n,s", [(2, 1), (9, 37), (13, 100), (6, 256), (4, 1536)])
def test_inter_counts_merge_equals_plain(n, s):
    """Widths of 1, not a multiple of 32, the path's 256 and the kernel's
    1536, with rows of every real size."""
    pad, ai, bi = _pads(n, s, n * s)
    got, _staged = inter_counts_emulated(pad, ai, bi)
    assert np.array_equal(got, _plain_counts(pad, ai, bi))


def test_inter_counts_all_padding_rows_and_runs():
    """All-padding rows count 0 with any row; in triu order a warp stages
    an a row once for the pairs of its run that share it; the walks read no
    word past a slot."""
    pad, ai, bi = _pads(23, 64, 8)
    pad[[1, 7]] = np.iinfo(np.int32).max
    reads = []
    got, staged = inter_counts_emulated(pad, ai, bi, reads=reads)
    want = _plain_counts(pad, ai, bi)
    assert np.array_equal(got, want)
    assert not want[(ai == 1) | (bi == 1) | (ai == 7) | (bi == 7)].any()
    runs = -(-ai.size // IC_RUN)
    assert runs <= staged < ai.size / 2
    assert max(reads) < ic_slot_words(64)


@pytest.mark.parametrize("broken", ["merge_start", "a_slot", "b_slot"])
def test_inter_counts_schedule_with_a_broken_index_disagrees(broken):
    pad, ai, bi = _pads(13, 100, 5)
    got, _staged = inter_counts_emulated(pad, ai, bi, broken)
    assert not np.array_equal(got, _plain_counts(pad, ai, bi))
