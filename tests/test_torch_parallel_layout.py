"""PyTorch port: the schedule of the candidate_counts kernels
(csrc/parallel.cu) checked on the CPU.

The kernels run only on the card. What is checked here is a numpy
transcription of their indexing, with the constants read from the .cu:
``cc_bounds_kernel``'s grid (a block of CB_THREADS threads a block of
CC_CANDS candidates, each thread reducing CB_PER of them; the (tile, side)
searches shared out over blockIdx.y, CB_WAYS lanes a search, each round
probing CB_WAYS positions and keeping the part where the predicate turns),
its zeroing of the block's rows of the
output and each tile's segment [lo, hi) (lo the first entry >= the block's
least live candidate, hi the first > its greatest; 0, 0 for a padding tile
or a block without a live candidate); ``cc_count_kernel``'s groups of
CC_TILES tiles, its ring of CC_SLOTS staged segments (tile i + CC_SLOTS - 1's
segment staged, from its first entry rounded down to 4 where rows are 16-byte
aligned, before tile i is searched in slot i % CC_SLOTS; nothing staged for a
padding tile or a segment beyond the slot, which is searched in device
memory inside the segment), each thread's searches of its CC_PER
consecutive candidates (halving steps, or doubling steps from the position
before when a candidate is greater than the one before) and counts, and its
run sums flushed by one modulo-2^32 add when the chromosome changes and at
the end. The transcription is held exact to ``candidate_counts_plain`` at ragged
sizes with sorted, unsorted and all-SENTINEL candidates, padding tiles,
chromosome changes inside a tile group, segments beyond the stage and sums
that wrap; a transcription with one index broken must disagree.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from subphaser_torch.ops.kmer import SENTINEL
from subphaser_torch.parallel import phase_step as tps
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SRC = Path(__file__).resolve().parents[1] / "subphaser_torch" / "csrc" / "parallel.cu"
TEXT = SRC.read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr (?:int|int32_t) {name} = ([^;]+);", TEXT)
    assert m, name
    return int(eval(m.group(1), {}, CONST))  # noqa: S307 (the .cu's own constants)


CONST: dict[str, int] = {}
for _name in ("SENTINEL", "CC_THREADS", "CC_PER", "CC_CANDS", "CC_TILES", "CC_STAGE",
              "CC_SLOTS", "CB_THREADS", "CB_PER", "CB_WAYS", "CB_SEARCHES"):
    CONST[_name] = _const(_name)
(CU_SENTINEL, CC_THREADS, CC_PER, CC_CANDS, CC_TILES, CC_STAGE, CC_SLOTS, CB_THREADS,
 CB_PER, CB_WAYS, CB_SEARCHES) = CONST.values()
BROKEN = ("segment_bound", "slot", "run_flush")


def test_constants():
    assert CU_SENTINEL == SENTINEL
    assert CC_CANDS == CC_THREADS * CC_PER and CB_THREADS * CB_PER == CC_CANDS
    assert CB_THREADS % 32 == 0 and CC_THREADS % 32 == 0
    assert 32 % CB_WAYS == 0 and CB_SEARCHES * CB_WAYS == CB_THREADS  # groups inside warps
    assert CC_TILES <= CC_THREADS  # a thread reads a tile's segment
    assert CC_SLOTS >= 2 and CC_STAGE % 4 == 0  # whole 16-byte copies
    assert CC_SLOTS * 2 * CC_STAGE * 4 + CC_TILES * 20 <= 48 * 1024  # static shared memory


def search_ways(row, v: int, upper: bool, live: bool) -> tuple[int, int]:
    """search_ways for one group of CB_WAYS lanes: (the first index whose
    entry is not below v, or not at or below it when upper; rounds)."""
    n = row.size
    lo, hi, rounds = 0, n if live else 0, 0
    while hi > lo:
        length = hi - lo
        k = np.arange(CB_WAYS)
        pos = lo + length * (k + 1) // (CB_WAYS + 1) if length > CB_WAYS else lo + k
        probe = np.full(CB_WAYS, length > CB_WAYS) | (k < length)
        x = row[np.minimum(pos, n - 1)].astype(np.int64)
        pred = probe & ((x <= v) if upper else (x < v))
        c = int(pred.sum())
        assert (np.diff(pred[probe].astype(int)) <= 0).all()  # trues, then falses
        if length > CB_WAYS:
            nlo = lo + length * c // (CB_WAYS + 1) + 1 if c > 0 else lo
            hi = lo + length * (c + 1) // (CB_WAYS + 1) if c < CB_WAYS else hi
            lo = nlo
        else:
            lo += c
            hi = lo
        rounds += 1
    return lo, rounds


def test_search_ways_rounds():
    """A 2^23-entry row takes at most ceil(23 / log2(CB_WAYS + 1)) rounds of
    CB_WAYS probes (23 by halving)."""
    row = np.arange(1 << 23, dtype=np.int32) * 2
    for v in (0, 5, 1 << 22, (1 << 24) - 2, 1 << 25):
        for upper in (False, True):
            got, rounds = search_ways(row, v, upper, True)
            assert got == np.searchsorted(row, v, "right" if upper else "left")
            assert rounds <= int(np.ceil(23 / np.log2(CB_WAYS + 1)))


def bounds_emulated(codes, chrom, cand, n_chrom, broken=""):
    """cc_bounds_kernel: (out with each candidate block's rows zeroed, the
    (blocks, T, 2) segments)."""
    t, n = codes.shape
    b = cand.size
    blocks = -(-b // CC_CANDS)
    gy = -(-2 * t // CB_SEARCHES)
    seg = np.full((blocks, t, 2), -7, np.int64)
    out = np.full((b, n_chrom), 0x5A5A5A5A, np.int64)  # what torch.empty may hold
    for g in range(blocks):
        # CB_THREADS threads, thread x reducing candidates x, x + CB_THREADS, ...
        mn, mx = np.iinfo(np.int32).max, np.iinfo(np.int32).min
        for r in range(CB_PER):
            idx = g * CC_CANDS + r * CB_THREADS + np.arange(CB_THREADS)
            c = np.where(idx < b, cand[np.minimum(idx, b - 1)], SENTINEL)
            live = c[c != SENTINEL]
            if live.size:
                mn, mx = min(mn, int(live.min())), max(mx, int(live.max()))
        out[g * CC_CANDS:min((g + 1) * CC_CANDS, b)] = 0
        for y in range(gy):
            for q0 in range(y * CB_SEARCHES, 2 * t, gy * CB_SEARCHES):
                for q in range(q0, min(q0 + CB_SEARCHES, 2 * t)):  # a group of lanes each
                    tile, side = q >> 1, q & 1
                    live = mn <= mx and chrom[tile] >= 0
                    upper = bool(side) and broken != "segment_bound"
                    seg[g, tile, side] = search_ways(codes[tile], mx if side else mn, upper,
                                                     live)[0]
    assert (seg >= 0).all()  # every (block, tile, side) written once
    return out, seg


def lower_bound_stage(a, length: int, v: int) -> int:
    """Halving steps from the largest power of 2 <= length."""
    pos, step = 0, 1 << (max(length, 1).bit_length() - 1)
    while step:
        if pos + step <= length and a[pos + step - 1] < v:
            pos += step
        step >>= 1
    return pos


def lower_bound_after(a, length: int, p: int, v: int) -> int:
    """Doubling steps from p (a[:p] < v), then halving."""
    step = 1
    while p + step <= length and a[p + step - 1] < v:
        p += step
        step <<= 1
    step >>= 1
    while step:
        if p + step <= length and a[p + step - 1] < v:
            p += step
        step >>= 1
    return p


def candidate_counts_emulated(codes, counts, chrom, cand, n_chrom, broken=""):
    """Both kernels: every block of the count grid, its staged slots (from the
    segment's first entry rounded down to 4 where rows are 16-byte aligned),
    each thread's searches of its CC_PER candidates and its run sums."""
    out, seg = bounds_emulated(codes, chrom, cand, n_chrom, broken)
    t, n = codes.shape
    b = cand.size
    vec = n % 4 == 0  # and the tensors 16-byte aligned, as torch allocates them
    for g in range(seg.shape[0]):
        bidx = g * CC_CANDS + np.arange(CC_CANDS).reshape(CC_THREADS, CC_PER)
        c = np.where(bidx < b, cand[np.minimum(bidx, b - 1)], SENTINEL).astype(np.int64)
        live = c != SENTINEL
        if not live.any():  # __syncthreads_or: the block leaves
            continue
        for y in range(-(-t // CC_TILES)):
            t0 = y * CC_TILES
            nt = min(CC_TILES, t - t0)
            lo, hi, ch = seg[g, t0:t0 + nt, 0], seg[g, t0:t0 + nt, 1], chrom[t0:t0 + nt]
            s_codes = np.full((CC_SLOTS, CC_STAGE), -3, np.int64)  # shared memory, unwritten
            s_counts = np.full((CC_SLOTS, CC_STAGE), 99, np.int64)
            start = lo & ~3 if vec else lo
            staged = hi - lo <= CC_STAGE - 3

            def stage(i):
                if i < nt and ch[i] >= 0 and staged[i]:
                    words = hi[i] - start[i]
                    rounded = -(-words // 4) * 4 if vec else words  # whole 16-byte copies
                    s_codes[i % CC_SLOTS, :rounded] = codes[t0 + i, start[i]:start[i] + rounded]
                    s_counts[i % CC_SLOTS, :rounded] = counts[t0 + i,
                                                              start[i]:start[i] + rounded]

            for i in range(CC_SLOTS - 1):
                stage(i)
            cur = -1
            acc = np.zeros((CC_THREADS, CC_PER), np.int64)
            for i in range(nt):
                stage(i + CC_SLOTS - 1)  # before tile i is searched
                if ch[i] < 0:
                    continue
                v = np.zeros((CC_THREADS, CC_PER), np.int64)
                for x in range(CC_THREADS):
                    if not live[x].any():
                        continue
                    if staged[i]:
                        length, off = int(hi[i] - lo[i]), int(lo[i] - start[i])
                        slot = (i + 1 if broken == "slot" else i) % CC_SLOTS
                        sc, sn = s_codes[slot, off:], s_counts[slot, off:]
                        p, prev = -1, 0
                        for r in range(CC_PER):
                            if not live[x, r]:
                                continue
                            if p >= 0 and c[x, r] > prev:
                                p = lower_bound_after(sc, length, p, c[x, r])
                            else:
                                p = lower_bound_stage(sc, length, c[x, r])
                            prev = c[x, r]
                            if p < length and sc[p] == c[x, r]:
                                v[x, r] = sn[p]
                    else:  # device memory, inside the segment
                        row = codes[t0 + i]
                        for r in range(CC_PER):
                            if live[x, r]:
                                j = lo[i] + np.searchsorted(row[lo[i]:hi[i]], c[x, r], "left")
                                if j < hi[i] and row[j] == c[x, r]:
                                    v[x, r] = counts[t0 + i, j]
                if ch[i] != cur:
                    flush = (acc != 0) & (cur >= 0)
                    if broken != "run_flush":
                        rows, cols = np.nonzero(flush)
                        out[bidx[rows, cols], cur] += acc[rows, cols]
                    acc[:] = 0
                    cur = ch[i]
                acc += v
            if cur >= 0:
                rows, cols = np.nonzero(acc)
                out[bidx[rows, cols], cur] += acc[rows, cols]
    return (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _spectra(n_tiles, n, rng, big_counts=False, fill=(0.75, 1.0)):
    codes = np.full((n_tiles, n), SENTINEL, np.int32)
    counts = np.zeros((n_tiles, n), np.int32)
    for t in range(n_tiles):
        u = np.unique(rng.integers(0, 1 << 16, size=int(n * rng.uniform(*fill))))[:n]
        codes[t, :u.size] = u
        hi = 1 << 30 if big_counts else 1 << 12
        counts[t, :u.size] = rng.integers(1, hi, size=u.size)
    return codes, counts


def _case(name: str):
    """(codes, counts, chrom, cand, n_chrom) of a named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n_tiles, n, n_cand, n_chrom = {
        "ragged": (19, 3000, 2600, 3), "unsorted": (9, 3000, 600, 2),
        "local_unsorted": (10, 2999, 1500, 2), "all_sentinel": (5, 500, 300, 2),
        "one": (1, 1, 1, 1), "padding_tiles": (11, 400, 300, 2), "sparse": (10, 6000, 520, 4),
        "wrap": (19, 2000, 1100, 1)}[name]
    codes, counts = _spectra(n_tiles, n, rng, big_counts=name == "wrap")
    real = codes[codes != SENTINEL]
    pool = np.unique(np.concatenate([real, rng.integers(0, 1 << 16, size=n_cand)]))
    if name == "sparse":  # sorted, every 10th code: a block spans ~5,000 entries
        pool = np.unique(real)[::10]
    cand = rng.choice(pool, size=min(n_cand, pool.size), replace=False).astype(np.int32)
    if name != "unsorted":
        cand.sort()
    if name == "local_unsorted":  # each thread's candidates descending, some repeated
        cand = cand[: cand.size // 4 * 4].reshape(-1, 4)[:, ::-1].reshape(-1).copy()
        cand[8::12] = cand[9::12][: cand[8::12].size]
    cand[rng.random(cand.size) < 0.05] = SENTINEL
    if name == "ragged":
        cand[CC_CANDS:2 * CC_CANDS] = SENTINEL  # a block without a live candidate
    if name == "all_sentinel":
        cand[:] = SENTINEL
    chrom = np.sort(rng.integers(0, n_chrom, size=n_tiles)).astype(np.int32)
    chrom[rng.random(n_tiles) < 0.15] = -1
    if name == "padding_tiles":
        chrom[:] = -1
        chrom[4] = 1
    if name == "ragged":  # a chromosome change inside each of the first two groups
        chrom[:] = np.repeat([0, 1, 2, -1, 2], [3, 7, 4, 1, 4])
    return codes, counts, chrom, cand, n_chrom


def _plain(codes, counts, chrom, cand, n_chrom):
    return tps.candidate_counts_plain(*(torch.from_numpy(a) for a in (codes, counts, chrom, cand)),
                                      n_chrom).numpy()


CASES = ["ragged", "unsorted", "local_unsorted", "all_sentinel", "one", "padding_tiles",
         "sparse", "wrap"]


@pytest.mark.parametrize("name", CASES)
def test_candidate_counts_schedule_equals_plain(name):
    args = _case(name)
    assert np.array_equal(candidate_counts_emulated(*args), _plain(*args))


def test_cases_reach_every_branch():
    """The cases hold a segment beyond the stage with sorted and with
    unsorted candidates, a staged segment with a thread's candidates not
    ascending and with rows not a multiple of 4 (4-byte copies), sums that
    wrap past 2^31, and a chromosome change inside a tile group."""
    for name in ("unsorted", "sparse"):
        codes, _counts, chrom, cand, n_chrom = _case(name)
        _out, seg = bounds_emulated(codes, chrom, cand, n_chrom)
        assert (seg[..., 1] - seg[..., 0] > CC_STAGE - 3).any(), name
    codes, _counts, chrom, cand, n_chrom = _case("local_unsorted")
    _out, seg = bounds_emulated(codes, chrom, cand, n_chrom)
    assert codes.shape[1] % 4 and (seg[..., 1] - seg[..., 0] <= CC_STAGE - 3).all()
    codes, counts, chrom, cand, n_chrom = _case("wrap")
    assert counts.astype(np.int64).sum(0).max() > 1 << 32
    codes, counts, chrom, cand, n_chrom = _case("ragged")
    group0 = chrom[:CC_TILES]
    assert len(set(group0[group0 >= 0].tolist())) > 1


@pytest.mark.parametrize("broken", BROKEN)
def test_candidate_counts_schedule_with_a_broken_index_disagrees(broken):
    args = _case("ragged")
    assert not np.array_equal(candidate_counts_emulated(*args, broken=broken), _plain(*args))
