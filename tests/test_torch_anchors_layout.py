"""PyTorch port: the index arithmetic of the anchor kernels
(csrc/anchors.cu) checked on the CPU.

The kernels run only on the card. What is checked here is a numpy
transcription of their indexing, with the constants read from the .cu:
kernel A's per-word arithmetic (``word_takes``: the 16 codes and hash
samples of a word from the word pair reversed once, the valid starts by
doubling runs, the 32-bit hash test; ``code_at``: a taken k-mer's code and
strand), its grid (runs of rounds x A_THREADS words, one word a thread and
round, at least A_ROUNDS rounds and at most A_MAX_BLOCKS blocks), the
count pass's (16, blocks) table and take masks, the write pass's own scan
of that table in offset-major order (a column a thread, each row's sum and
its sum before the block, a scan of the row sums), its rounds (a ballot
rank a warp and offset, the warps' counts scanned over the offsets by
every warp, each offset's run in the staging area, the taken k-mers'
codes, the copy-out's search for the run of a staged slot), the cap, the
early return and the pads shared out over the blocks; kernel B's kept run
lengths, its grid of TILE query anchors a block walked in ROUNDS rounds of
THREADS, scan_kernel's chunked exclusive scan (one block, a serial chunk a
thread, Hillis-Steele over the threads), and the emit pass's rows (a warp
inclusive scan by shuffles and the warp totals). Each transcription is
held exact to the plain versions (``sampled_anchors_plain``,
``match_emit_plain``) at tiles of one and of several blocks, the last
ragged, caps that fall inside a block's runs and below a block's first
slot; a transcription with one index broken must disagree.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from subphaser_torch.ops import anchors as ta
from subphaser_torch.ops.kmer import SENTINEL
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SRC = Path(__file__).resolve().parents[1] / "subphaser_torch" / "csrc" / "anchors.cu"
TEXT = SRC.read_text()


def _const(name: str) -> int:
    m = re.search(rf"constexpr (?:int|int32_t|uint32_t) {name} = ([^;]+);", TEXT)
    assert m, name
    return int(eval(m.group(1).rstrip("u"), {}, CONST))  # noqa: S307 (the .cu's constants)


CONST: dict[str, int] = {}
for _name in ("THREADS", "WARPS", "ROUNDS", "TILE", "SCAN_THREADS", "SENTINEL", "HASH_MUL",
              "OFFSETS", "A_THREADS", "A_WARPS", "A_ROUNDS", "A_MAX_BLOCKS", "STAGE",
              "NIB_ROUNDS"):
    CONST[_name] = _const(_name)
(THREADS, WARPS, ROUNDS, TILE, SCAN_THREADS, CU_SENTINEL, HASH_MUL, OFFSETS, A_THREADS, A_WARPS,
 A_ROUNDS, A_MAX_BLOCKS, STAGE, NIB_ROUNDS) = CONST.values()


def test_constants():
    assert CU_SENTINEL == SENTINEL and HASH_MUL == ta.HASH_MUL
    assert WARPS * 32 == THREADS and TILE == THREADS * ROUNDS
    assert ta._blocks(TILE) == 1 and ta._blocks(TILE + 1) == 2  # kernel B's grid
    assert OFFSETS == 16 and A_WARPS * 32 == A_THREADS and STAGE == A_THREADS * OFFSETS
    assert A_THREADS <= 256  # a thread index fits the staged meta's 8 bits


def _grid_a(W: int):
    """sample_grid: (rounds a block, blocks)."""
    units = -(-W // A_THREADS)
    rounds = max(A_ROUNDS, -(-units // A_MAX_BLOCKS))
    return rounds, -(-units // rounds)


@pytest.mark.parametrize("W", [1, 255, 256, 2048, 2049, 5000, 1 << 19, (1 << 20) + 1,
                               (1 << 27) - 1])
def test_kernel_a_grid(W):
    """Runs cover the tile once; past A_MAX_BLOCKS blocks a block takes
    more rounds; the 2^23-base tile takes 512 blocks of 4 rounds."""
    rounds, nb = _grid_a(W)
    run = rounds * A_THREADS
    assert (nb - 1) * run < W <= nb * run
    assert rounds >= A_ROUNDS and nb <= A_MAX_BLOCKS
    if W == 1 << 19:
        assert (rounds, nb) == (4, 512)


def _grid(n: int):
    """Flat indices of each (block, round, thread): f = b * TILE + r * THREADS + t."""
    nb = -(-n // TILE)
    b, r, t = np.meshgrid(np.arange(nb), np.arange(ROUNDS), np.arange(THREADS), indexing="ij")
    return nb, b * TILE + r * THREADS + t  # (nb, ROUNDS, THREADS)


def _scan(counts: np.ndarray):
    """scan_kernel: counts -> (exclusive offsets, total)."""
    nb = counts.size
    chunk = -(-nb // SCAN_THREADS)
    sums = np.zeros(SCAN_THREADS, np.int64)
    for t in range(SCAN_THREADS):
        sums[t] = counts[t * chunk: min(t * chunk + chunk, nb)].sum()
    own = sums.copy()
    o = 1
    while o < SCAN_THREADS:  # Hillis-Steele, inclusive
        sums = sums + np.concatenate([np.zeros(o, np.int64), sums[:-o]])
        o *= 2
    out = np.empty(nb, np.int64)
    for t in range(SCAN_THREADS):
        run = sums[t] - own[t]
        for i in range(t * chunk, min(t * chunk + chunk, nb)):
            out[i] = run
            run += counts[i]
    return out, int(sums[-1])


U32 = np.uint64(0xFFFFFFFF)


def _brev(x):
    """__brev on 32-bit values held in uint64."""
    for shift, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF),
                     (16, 0x0000FFFF)):
        s, m = np.uint64(shift), np.uint64(m)
        x = ((x >> s) & m) | ((x & m) << s)
    return x


def _reverse2bits(x):
    x = _brev(x)
    m = np.uint64(0x55555555)
    return ((x >> np.uint64(1)) & m) | ((x & m) << np.uint64(1))


def _valid_starts(vv, k: int):
    """valid_starts: doubling runs, then one overlapping step."""
    run, length = vv, 1
    while 2 * length <= k:
        run = run & (run >> np.uint64(length))
        length *= 2
    return run & (run >> np.uint64(k - length)) if length < k else run


def _pair(words, vwords, w):
    u = lambda a: a.view(np.uint32).astype(np.uint64)  # noqa: E731
    return u(words[w]), u(words[w + 1]), u(vwords[w]), u(vwords[w + 1])


def _word_takes(words, vwords, k: int, thr: int, w: np.ndarray):
    """word_takes at the words ``w``: (16,) + w.shape bools; the hash test
    as the entry passes it (<= thr - 1 in 32 bits, nothing at thr = 0)."""
    w0, w1, v0, v1 = _pair(words, vwords, w)
    mask = np.uint64((1 << (2 * k)) - 1)
    lim = np.uint64(max(thr - 1, 0))
    r = (_reverse2bits(w0) << np.uint64(32)) | _reverse2bits(w1)
    x = r >> np.uint64(34 - 2 * k)
    pair = w0 | (w1 << np.uint64(32))
    starts = _valid_starts((v0 | (v1 << np.uint64(16))) & U32, k)
    take = []
    for p in range(OFFSETS):
        val = (pair >> np.uint64(2 * p)) & U32  # __funnelshift_r(w0, w1, 2p)
        fwd = (x >> np.uint64(30 - 2 * p)) & mask
        c = np.minimum(fwd, ~val & mask)
        valid = ((starts >> np.uint64(p)) & np.uint64(1)) == 1
        take.append(valid & (((c * np.uint64(HASH_MUL)) & U32) <= lim) & (thr > 0))
    return np.stack(take)


def _code_at(words, w: np.ndarray, k: int, p: np.ndarray):
    """code_at: (canonical code, strand) of the k-mers at offsets ``p`` of
    the words ``w``, from the pair reversed."""
    w0, w1, _v0, _v1 = _pair(words, words, w)
    mask = np.uint64((1 << (2 * k)) - 1)
    rev = (_reverse2bits(w0) << np.uint64(32)) | _reverse2bits(w1)
    fwd = (rev >> (np.uint64(64 - 2 * k) - np.uint64(2) * p.astype(np.uint64))) & mask
    val = ((w0 | (w1 << np.uint64(32))) >> (np.uint64(2) * p.astype(np.uint64))) & U32
    c = np.minimum(fwd, ~val & mask)
    return c, (c != fwd).astype(np.int64)


def _thread_counts(take: np.ndarray, every: int = NIB_ROUNDS) -> np.ndarray:
    """sample_count_kernel's counters: take (16, nb, rounds, threads) ->
    each thread's count at each offset (16, nb, threads), added up in 4-bit
    fields (nibble q of nib[j] holds offset 4q + j) emptied into the
    counters every ``every`` rounds and at the end; a field keeps 4 bits."""
    bits = (take.astype(np.uint32) << np.arange(OFFSETS, dtype=np.uint32)[:, None, None, None])
    masks = bits.sum(axis=0, dtype=np.uint64).astype(np.uint32)  # (nb, rounds, threads)
    nb, rounds, threads = masks.shape
    cnt = np.zeros((OFFSETS, nb, threads), np.int64)
    nib = np.zeros((4, nb, threads), np.uint32)

    def flush():
        for p in range(OFFSETS):
            cnt[p] += (nib[p & 3] >> np.uint32(4 * (p >> 2))) & np.uint32(15)
        nib[:] = 0

    for r in range(rounds):
        for j in range(4):
            nib[j] = (nib[j] + ((masks[:, r] >> np.uint32(j)) & np.uint32(0x1111))) & 0xFFFFFFFF
        if r % every == every - 1:
            flush()
    flush()
    return cnt


def test_count_pass_nibbles():
    """Counters of every offset taken in every round, over more rounds than
    a nibble holds: the flush every NIB_ROUNDS rounds keeps them exact; a
    flush one round later overflows a nibble."""
    take = np.ones((OFFSETS, 2, 40, 3), bool)
    take[3, 1, 7, 2] = False
    want = take.sum(axis=2)
    assert NIB_ROUNDS <= 15
    assert np.array_equal(_thread_counts(take), want)
    assert not np.array_equal(_thread_counts(take, NIB_ROUNDS + 1), want)


def _table_offsets(table: np.ndarray, b: int, broken: str = ""):
    """The write pass's scan of the (16, nb) table at block b: each row's
    sum and the sum of its entries before b (thread t on columns t,
    t + A_THREADS, ..., then warp reductions), a scan of the row sums over
    the offsets: (the 16 offsets, the total)."""
    nb = table.shape[1]
    col = np.arange(nb)
    rows, pre = np.zeros(OFFSETS, np.int64), np.zeros(OFFSETS, np.int64)
    for t in range(A_THREADS):
        c = col[t::A_THREADS]
        rows += table[:, c].sum(axis=1)
        pre += table[:, c[c < b]].sum(axis=1)
    if broken == "table_block_major":  # the blocks before b first, all offsets
        return np.cumsum(table[:, b]) - table[:, b] + table[:, :b].sum(), int(rows.sum())
    return np.cumsum(rows) - rows + pre, int(rows.sum())


def _kernel_a(words, vwords, k, W, mod, cap, broken=""):
    """Both launches of kernel A in numpy."""
    thr = (1 << 32) // mod
    rounds, nb = _grid_a(W)
    b, r, t = np.meshgrid(np.arange(nb), np.arange(rounds), np.arange(A_THREADS), indexing="ij")
    w = (b * rounds + r) * A_THREADS + t  # (nb, rounds, A_THREADS)
    inside = w < W
    take = _word_takes(words, vwords, k, thr, np.where(inside, w, 0)) & inside
    table = _thread_counts(take).sum(axis=2)  # sample_count_kernel: (16, nb), and the masks
    out_c = np.full(cap, -7, np.int32)
    out_p, out_s = out_c.copy(), out_c.copy()
    total = int(table.sum())
    for blk in range(nb):
        off, total = _table_offsets(table, blk, broken)
        if off[0] >= cap:
            continue
        done = np.zeros(OFFSETS, np.int64)
        for rr in range(rounds):
            tk = take[:, blk, rr]  # (16, A_THREADS)
            per_warp = tk.reshape(OFFSETS, A_WARPS, 32)
            wc = per_warp.sum(axis=2)  # popc of each ballot
            acc = wc.sum(axis=1)
            rp = np.cumsum(acc) - acc  # every warp's shuffle scan over the offsets
            base = np.cumsum(wc, axis=1) - wc + rp[:, None]  # rp + the warps before
            s_out = off + done
            done += acc
            rank = np.cumsum(per_warp, axis=2) - per_warp  # popc(ballot & below)
            if broken == "rank_with_own_lane":
                rank = rank + 1
            slot = base[:, np.arange(A_THREADS) // 32] + rank.reshape(OFFSETS, A_THREADS)
            staged = int(acc.sum())
            s_code = np.full(STAGE, -1, np.int64)
            s_meta = np.full(STAGE, -1, np.int64)
            pp, tt = np.nonzero(tk)  # the taken k-mers' codes, from the words
            code, strand = _code_at(words, w[blk, rr, tt], k, pp)
            s_code[slot[pp, tt]] = code
            s_meta[slot[pp, tt]] = tt | (strand << 8)
            e = np.arange(staged)
            p = np.zeros(staged, np.int64)
            step = OFFSETS // 2
            while step:
                nxt = rp[p + step]
                p = np.where(nxt < e if broken == "run_search_strict" else nxt <= e,
                             p + step, p)
                step //= 2
            o = s_out[p] + e - rp[p]
            ok = o < cap
            meta = s_meta[e]
            out_c[o[ok]] = s_code[e][ok]
            out_p[o[ok]] = (((blk * rounds + rr) * A_THREADS + (meta & 0xFF)) * OFFSETS + p)[ok]
            out_s[o[ok]] = (meta >> 8)[ok]
    for blk in range(nb):  # each block's share of the pads, written after its scan
        i = np.arange(min(total, cap) + blk * A_THREADS, cap, nb * A_THREADS)[:, None] \
            + np.arange(A_THREADS)[None, :]
        i = i[i < cap]
        out_c[i], out_p[i], out_s[i] = SENTINEL, -1, 0
    return out_c, out_p, out_s, total


def _tile(W: int, seed: int, n_frac: float):
    rng = np.random.default_rng(seed)
    words = rng.integers(-(1 << 31), 1 << 31, W + 1, dtype=np.int64).astype(np.int32)
    bits = (rng.random((W + 1, 16)) >= n_frac).astype(np.int64)
    vwords = (bits << np.arange(16)).sum(axis=1).astype(np.int32)
    vwords[-1] = 0  # past the tile
    return words, vwords


@pytest.mark.parametrize("W,k,mod,cap,n_frac", [
    (300, 15, 16, 4096, 0.01),   # one block, its run ragged
    (300, 15, 16, 160, 0.01),    # a cap inside the block's runs
    (256, 13, 4, 1100, 0.0),     # a cap near the block's count
    (129, 7, 8, 512, 0.3),       # many invalid bases
    (5000, 15, 16, 1 << 14, 0.01),  # five blocks, the last ragged
    (5000, 15, 16, 100, 0.01),   # a cap below the later blocks' first slots
    (4400, 13, 4, 1 << 15, 0.2),  # several blocks at a higher density
])
def test_kernel_a_matches_plain(W, k, mod, cap, n_frac):
    words, vwords = _tile(W, W + k, n_frac)
    kw = dict(k=k, n_pos_words=W, mod=mod, cap=cap)
    want = ta.sampled_anchors_plain(torch.from_numpy(words), torch.from_numpy(vwords), **kw)
    got = _kernel_a(words, vwords, k, W, mod, cap)
    for w, g in zip(want[:3], got[:3]):
        assert np.array_equal(w.numpy(), g)
    assert int(want[3]) == got[3]
    if cap == 160:
        assert got[3] > cap
        broken = _kernel_a(words, vwords, k, W, mod, cap, broken="rank_with_own_lane")
        assert not np.array_equal(broken[0], got[0])


def test_scan_kernel_chunks():
    """More blocks than scan threads: every thread scans a chunk of 3."""
    counts = np.random.default_rng(0).integers(0, 2049, 2 * SCAN_THREADS + 5)
    offsets, total = _scan(counts)
    assert np.array_equal(offsets, np.cumsum(counts) - counts) and total == counts.sum()


def _kernel_b(qc, q_occ, qp, qs, tp_s, ts_s, lo, hi, max_occ, broken=False):
    n = qc.size
    nb, f = _grid(n)
    inside = f < n
    i = np.where(inside, f, 0)
    run = hi[i] - lo[i]
    keep = inside & (run > 0) & (run <= max_occ) & (q_occ[i] <= max_occ) & (qc[i] != SENTINEL)
    lens = np.where(keep, run, 0)
    offsets, total = _scan(lens.sum(axis=(1, 2)))
    out = np.full((3, total), -7, np.int32)
    for b in range(nb):
        running = offsets[b]
        for r in range(ROUNDS):
            ln = lens[b, r].reshape(WARPS, 32)
            incl = np.cumsum(ln, axis=1)  # the warp's shuffle scan
            before = np.concatenate([[0], np.cumsum(incl[:, -1])[:-1]])[:, None]
            rows = (running + before + incl - (0 if broken else ln)).reshape(-1)
            for t in np.flatnonzero(lens[b, r]):
                q = i[b, r, t]
                for j in range(lens[b, r, t]):
                    if rows[t] + j < total:
                        out[:, rows[t] + j] = (qp[q], tp_s[lo[q] + j],
                                               int(qs[q] != ts_s[lo[q] + j]))
            running += ln.sum()
    return out


@pytest.mark.parametrize("n_q,n_t,n_codes", [(5000, 6000, 3000), (2049, 400, 100)])
def test_kernel_b_matches_plain(n_q, n_t, n_codes):
    rng = np.random.default_rng(n_q)
    qc = rng.integers(0, n_codes, n_q).astype(np.int32)
    qc[rng.random(n_q) < 0.05] = SENTINEL
    tc = np.sort(rng.integers(0, n_codes, n_t)).astype(np.int32)
    tp_s = rng.integers(0, 1 << 30, n_t).astype(np.int32)
    ts_s = rng.integers(0, 2, n_t).astype(np.int32)
    qp = rng.integers(0, 1 << 30, n_q).astype(np.int32)
    qs = rng.integers(0, 2, n_q).astype(np.int32)
    qsort = np.sort(qc)
    q_occ = (np.searchsorted(qsort, qc, "right") - np.searchsorted(qsort, qc)).astype(np.int32)
    lo = np.searchsorted(tc, qc).astype(np.int32)
    hi = np.searchsorted(tc, qc, "right").astype(np.int32)
    args = (qc, q_occ, qp, qs, tp_s, ts_s, lo, hi)
    want = ta.match_emit_plain(*(torch.from_numpy(x) for x in args), max_occ=8)
    got = _kernel_b(*args, max_occ=8)
    assert got.shape[1] > 0
    for w, g in zip(want, got):
        assert np.array_equal(w.numpy(), g)
    assert not np.array_equal(_kernel_b(*args, max_occ=8, broken=True), got)


@pytest.mark.parametrize("broken", ["table_block_major", "rank_with_own_lane",
                                    "run_search_strict"])
def test_kernel_a_with_a_broken_index_disagrees(broken):
    W, k, mod, cap = 5000, 15, 16, 1 << 14
    words, vwords = _tile(W, 9, 0.01)
    got = _kernel_a(words, vwords, k, W, mod, cap, broken)
    want = ta.sampled_anchors_plain(torch.from_numpy(words), torch.from_numpy(vwords), k=k,
                                    n_pos_words=W, mod=mod, cap=cap)
    assert not all(np.array_equal(w.numpy(), g) for w, g in zip(want[:3], got[:3]))


@pytest.mark.parametrize("mod", [1, 3, 1 << 33])
def test_kernel_a_hash_limits(mod):
    """mod 1 takes every valid start (thr = 2^32, lim = 2^32 - 1); a mod
    above 2^32 none (thr = 0)."""
    W, k = 2100, 11
    words, vwords = _tile(W, 5, 0.05)
    kw = dict(k=k, n_pos_words=W, mod=mod, cap=1 << 16)
    want = ta.sampled_anchors_plain(torch.from_numpy(words), torch.from_numpy(vwords), **kw)
    got = _kernel_a(words, vwords, k, W, mod, 1 << 16)
    for w, g in zip(want[:3], got[:3]):
        assert np.array_equal(w.numpy(), g)
    assert int(want[3]) == got[3] and (got[3] == 0) == (mod > 1 << 32)


def test_word_takes_and_code_at_equal_the_codes():
    """word_takes' and code_at's arithmetic gives ops/kmer's canonical codes
    and strands at every valid start, for every k."""
    from subphaser_torch.ops.kmer import forward_codes, kmer_codes

    W = 300
    words, vwords = _tile(W, 4, 0.02)
    w = np.broadcast_to(np.arange(W), (OFFSETS, W))
    p = np.broadcast_to(np.arange(OFFSETS)[:, None], (OFFSETS, W))
    for k in range(1, 16):
        take = _word_takes(words, vwords, k, 1 << 32, np.arange(W))
        canon, strand = _code_at(words, w, k, p)
        tw, tv = torch.from_numpy(words), torch.from_numpy(vwords)
        want = kmer_codes(tw, tv, k, W).numpy()  # (16, W)
        fwd = forward_codes(tw, tv, k, W).numpy()
        valid = want != SENTINEL
        assert np.array_equal(take, valid)  # mod 1 takes every valid start
        assert np.array_equal(canon[valid].astype(np.int64), want[valid])
        assert np.array_equal(strand[valid], (want != fwd)[valid])
