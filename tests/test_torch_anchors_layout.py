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
early return and the pads shared out over the blocks; kernel B's scan
(match_scan_kernel: TILE queries a block read by VEC-query vector loads in
ROUNDS rounds, each query's scan word kept << KEPT_SHIFT | run length, the
thread, warp and round sums inside the block, the status words published
with FLAG_AGGREGATE and FLAG_PREFIX and the decoupled look-back over
windows of LOOKBACK predecessors, for any order in which the blocks run,
the kept queries staged in query order before the look-back and copied
out behind the blocks before, the totals) and its
emit (match_emit_kernel: runs of RUN kept queries a warp, 32 x EMIT_ROWS rows
a step, each row's query found by a binary search of the run's first
rows). Each
transcription is held exact to the plain versions (``sampled_anchors_plain``,
``match_emit_plain``) at tiles of one and of several blocks, the last
ragged, caps that fall inside a block's runs and below a block's first
slot, and joins below one tile, with a ragged last tile, with every kept
query in one block and with none kept; a transcription with one index,
flag or search broken must disagree.
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
for _name in ("THREADS", "WARPS", "VEC", "ROUNDS", "TILE", "LOOKBACK", "KEPT_SHIFT",
              "FLAG_SHIFT", "FLAG_AGGREGATE", "FLAG_PREFIX", "RUN", "EMIT_ROWS", "SENTINEL",
              "HASH_MUL",
              "OFFSETS", "A_THREADS", "A_WARPS", "A_ROUNDS", "A_MAX_BLOCKS", "STAGE",
              "NIB_ROUNDS"):
    CONST[_name] = _const(_name)
(THREADS, WARPS, VEC, ROUNDS, TILE, LOOKBACK, KEPT_SHIFT, FLAG_SHIFT, FLAG_AGGREGATE,
 FLAG_PREFIX, RUN, EMIT_ROWS, CU_SENTINEL, HASH_MUL, OFFSETS, A_THREADS, A_WARPS, A_ROUNDS, A_MAX_BLOCKS,
 STAGE, NIB_ROUNDS) = CONST.values()


def test_constants():
    assert CU_SENTINEL == SENTINEL and HASH_MUL == ta.HASH_MUL
    assert WARPS * 32 == THREADS and TILE == THREADS * VEC * ROUNDS and VEC == 4  # 16 B loads
    assert LOOKBACK == 32 and RUN == 32 and EMIT_ROWS >= 1  # a warp's lanes
    # a kept count and a pair count (each below 2^31) share a scan word, and
    # a status word's flag sits above both
    assert KEPT_SHIFT == 31 and FLAG_SHIFT == 2 * KEPT_SHIFT
    assert {FLAG_AGGREGATE, FLAG_PREFIX} == {1, 2}  # 0: not yet published
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


PAIRS = (1 << KEPT_SHIFT) - 1
INT32_MAX = (1 << 31) - 1


def _scan_words(qc, q_occ, lo, hi, max_occ: int) -> np.ndarray:
    """scan_word of every query: kept << KEPT_SHIFT | run length, 0 when
    dropped (the keep rule of _combine_runs)."""
    run = hi.astype(np.int64) - lo
    keep = (run > 0) & (run <= max_occ) & (q_occ <= max_occ) & (qc != SENTINEL)
    return np.where(keep, (1 << KEPT_SHIFT) | run, 0).astype(np.uint64)


def _block_scan(words: np.ndarray, b: int):
    """One block of match_scan_kernel before its look-back: its TILE words
    (zero past n) as (round, warp, lane, j); each thread's sum a round,
    the warps' inclusive shuffle scans, the warp totals (s_warp), and each
    query's prefix inside the block (pre[round] + the lanes before + the
    thread's words before). Returns (aggregate, prefixes (TILE,))."""
    tile = np.zeros(TILE, np.uint64)
    part = words[b * TILE:(b + 1) * TILE]
    tile[:part.size] = part
    w = tile.reshape(ROUNDS, WARPS, 32, VEC)
    t = w.sum(axis=3)  # a thread's VEC words of a round
    incl = np.cumsum(t, axis=2)  # the warp's inclusive scan
    s_warp = incl[:, :, -1]  # (ROUNDS, WARPS)
    flat = s_warp.reshape(-1)
    pre = (np.cumsum(flat) - flat).reshape(ROUNDS, WARPS)  # rounds before, then warps
    excl = pre[:, :, None] + incl - t  # the thread's first word
    within = np.cumsum(w, axis=3) - w
    return int(flat.sum()), (excl[:, :, :, None] + within).reshape(-1)


def _look_back(status: list, b: int, state: dict, broken: str = ""):
    """Warp 0's look-back from block b, resumable: reads windows of LOOKBACK
    status words (lane 0 the nearest block, past block 0 a prefix of 0);
    returns the sum before b, or None where a word of the window is still 0
    (the warp spins: it reads the same window again later)."""
    while True:
        i = state["pos"] - np.arange(LOOKBACK)
        s = [status[j] if j >= 0 else FLAG_PREFIX << FLAG_SHIFT for j in i]
        flags = [x >> FLAG_SHIFT for x in s]
        if 0 in flags:
            return None
        stop = FLAG_AGGREGATE if broken == "status_flag" else FLAG_PREFIX
        hit = [lane for lane, f in enumerate(flags) if f >= stop]  # the ballot
        last = hit[0] if hit else LOOKBACK - 1
        if broken == "look_back":
            last -= 1  # the prefix word's own value left out
        state["before"] += sum(x & ((1 << FLAG_SHIFT) - 1) for x in s[:last + 1])
        if hit:
            return state["before"]
        state["pos"] -= LOOKBACK


def _kernel_b_scan(qc, q_occ, qp, qs, lo, hi, max_occ, order=None, broken=""):
    """match_scan_kernel in numpy, its blocks run in ``order`` (a
    permutation of the blocks; block order by default): a block publishes
    its aggregate, stages its kept queries in query order (lo, first row
    inside the block, position, strand), then looks back; a block whose
    look-back meets an unpublished word waits, and the waiting blocks are
    tried again, in turn, after every block that publishes; a block that
    knows its prefix copies its staged queries out behind the kept queries
    before it. Returns (status words, totals, the compact list (k_lo,
    k_row, k_pos, k_str))."""
    n = qc.size
    words = _scan_words(qc, q_occ, lo, hi, max_occ)
    nb = -(-n // TILE)
    status = [0] * nb
    state = {}
    lst = np.full((4, n), -7, np.int64)
    totals = [None, None]

    def stage(b: int, pre: np.ndarray) -> np.ndarray:
        """The block's staging area: (4, TILE) at the kept queries' local
        places."""
        i = b * TILE + np.arange(TILE)
        kept = (i < n) & (words[np.minimum(i, n - 1)] != 0)
        k = (pre[kept] >> np.uint64(KEPT_SHIFT)).astype(np.int64)
        staged = np.full((4, TILE), -9, np.int64)
        staged[0, k] = lo[i[kept]]
        staged[1, k] = (pre[kept] & np.uint64(PAIRS)).astype(np.int64)
        staged[2, k], staged[3, k] = qp[i[kept]], qs[i[kept]]
        return staged

    def finish(b: int, before: int):
        agg, staged = state[b]["agg"], state[b]["staged"]
        if b > 0:
            status[b] = FLAG_PREFIX << FLAG_SHIFT | (before + agg)
        if b == nb - 1:
            totals[:] = [(before + agg) & PAIRS, (before + agg) >> KEPT_SHIFT]
        k0, row0, count = before >> KEPT_SHIFT, before & PAIRS, agg >> KEPT_SHIFT
        lst[:, k0:k0 + count] = staged[:, :count]
        lst[1, k0:k0 + count] += row0
        state[b]["done"] = True

    order = list(range(nb)) if order is None else order
    assert sorted(order) == list(range(nb))
    waiting = []
    for b in order:
        agg, pre = _block_scan(words, b)
        state[b] = {"agg": agg, "staged": stage(b, pre), "pos": b - 1, "before": 0,
                    "done": False}
        status[b] = (FLAG_PREFIX if b == 0 else FLAG_AGGREGATE) << FLAG_SHIFT | agg
        waiting.append(b)
        progress = True
        while progress:
            progress = False
            for w in list(waiting):
                before = 0 if w == 0 else _look_back(status, w, state[w], broken)
                if before is not None:
                    waiting.remove(w)
                    finish(w, before)
                    progress = True
    assert not waiting and all(v["done"] for v in state.values())
    n_pairs, n_kept = totals
    return status, (n_pairs, n_kept), tuple(lst[:, :n_kept])


def _kernel_b_emit(tp_s, ts_s, n_pairs, k_lo, k_row, k_pos, k_str, broken=""):
    """match_emit_kernel in numpy: a warp a run of RUN kept queries, one a
    lane (past the list: first row INT32_MAX); the run's rows 32 x
    EMIT_ROWS at a step, EMIT_ROWS a lane; a row's query by the binary
    search of the lanes' first rows."""
    n_kept = k_lo.size
    out = np.full((3, n_pairs), -7, np.int64)
    for first in range(0, n_kept, RUN):
        k = first + np.arange(RUN)
        has = k < n_kept
        ks = np.minimum(k, n_kept - 1)
        row = np.where(has, k_row[ks], INT32_MAX)
        t0 = np.where(has, k_lo[ks], 0)
        pos = np.where(has, k_pos[ks], 0)
        strand = np.where(has, k_str[ks], 0)
        end = k_row[first + RUN] if first + RUN < n_kept else n_pairs
        steps = [base + h * 32 for base in range(row[0], end, 32 * EMIT_ROWS)
                 for h in range(EMIT_ROWS)]
        for start in steps:
            r = start + np.arange(32)
            p = np.zeros(32, np.int64)
            step = RUN // 2
            while step:
                v = row[p + step]
                p = np.where(v < r if broken == "row_search" else v <= r, p + step, p)
                step //= 2
            t = t0[p] + r - row[p]
            ok = r < end
            tpos = np.take(tp_s, t, mode="clip")  # a broken search may read past the end
            tstr = np.take(ts_s, t, mode="clip")
            out[0, r[ok]] = pos[p][ok]
            out[1, r[ok]] = tpos[ok]
            out[2, r[ok]] = (strand[p] != tstr)[ok]
    return out


def _kernel_b(qc, q_occ, qp, qs, tp_s, ts_s, lo, hi, max_occ, order=None, broken=""):
    """Both launches of kernel B: (the outputs (3, pairs), the totals)."""
    _status, (n_pairs, n_kept), lst = _kernel_b_scan(qc, q_occ, qp, qs, lo, hi, max_occ, order,
                                                     broken)
    if n_pairs == 0:
        return np.zeros((3, 0), np.int64), (n_pairs, n_kept)
    return _kernel_b_emit(tp_s, ts_s, n_pairs, *lst, broken=broken), (n_pairs, n_kept)


def _join(n_q: int, n_t: int, n_codes: int, seed: int, keep_block: int | None = None):
    """A random join as match_anchors_dev hands it to the kernel; with
    ``keep_block``, every query outside that block of the scan has no
    target, so every kept query falls in that one block."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, n_codes, n_q).astype(np.int32)
    qc[rng.random(n_q) < 0.05] = SENTINEL
    if keep_block is not None:
        outside = np.ones(n_q, bool)
        outside[keep_block * TILE:(keep_block + 1) * TILE] = False
        qc[outside] = np.where(qc[outside] == SENTINEL, SENTINEL, qc[outside] + n_codes)
    tc = np.sort(rng.integers(0, n_codes, n_t)).astype(np.int32)
    tp_s = rng.integers(0, 1 << 30, n_t).astype(np.int32)
    ts_s = rng.integers(0, 2, n_t).astype(np.int32)
    qp = rng.integers(0, 1 << 30, n_q).astype(np.int32)
    qs = rng.integers(0, 2, n_q).astype(np.int32)
    qsort = np.sort(qc)
    q_occ = (np.searchsorted(qsort, qc, "right") - np.searchsorted(qsort, qc)).astype(np.int32)
    lo = np.searchsorted(tc, qc).astype(np.int32)
    hi = np.searchsorted(tc, qc, "right").astype(np.int32)
    return qc, q_occ, qp, qs, tp_s, ts_s, lo, hi


JOINS = {
    "below_one_tile": (TILE // 3, 600, 300, None),
    "ragged_last_tile": (5 * TILE + 77, 6 * TILE, 3 * TILE, None),
    "kept_in_one_block": (4 * TILE + 5, 2 * TILE, TILE, 2),
    "none_kept": (3 * TILE, 400, 300, None),  # every run made empty
    "one_full_tile": (TILE, 1500, 1000, None),
}


@pytest.mark.parametrize("case", list(JOINS))
def test_kernel_b_matches_plain(case):
    n_q, n_t, n_codes, keep_block = JOINS[case]
    args = _join(n_q, n_t, n_codes, n_q, keep_block)
    if case == "none_kept":
        args = args[:7] + (args[6],)
    want = ta.match_emit_plain(*(torch.from_numpy(x) for x in args), max_occ=8)
    got, (n_pairs, n_kept) = _kernel_b(*args, max_occ=8)
    assert got.shape[1] == n_pairs
    for w, g in zip(want, got):
        assert np.array_equal(w.numpy(), g)
    qc, q_occ, qp, qs, _tp, _ts, lo, hi = args
    _status, _totals, (klo, krow, kpos, kstr) = _kernel_b_scan(qc, q_occ, qp, qs, lo, hi, 8)
    kept = np.flatnonzero(_scan_words(qc, q_occ, lo, hi, 8))  # the list in query order
    run = hi[kept].astype(np.int64) - lo[kept]
    assert np.array_equal(klo, lo[kept]) and np.array_equal(krow, np.cumsum(run) - run)
    assert np.array_equal(kpos, qp[kept]) and np.array_equal(kstr, qs[kept])
    if case == "none_kept":
        assert n_pairs == 0 and n_kept == 0
    else:
        assert n_pairs > n_kept > 0
    if case == "kept_in_one_block":
        assert np.all(kept // TILE == keep_block)


def _orders(nb: int) -> dict:
    return {"block_order": list(range(nb)), "reverse": list(range(nb))[::-1],
            "seeded_random": list(np.random.default_rng(nb).permutation(nb))}


@pytest.mark.parametrize("order", ["block_order", "reverse", "seeded_random"])
def test_look_back_prefixes_in_any_order(order):
    """More blocks than an H100 holds at once (132 SMs x 8 blocks):
    whatever order the blocks publish in, the look-back gives every block
    the sum of the blocks before it, the compact list is the same and the
    totals are the whole sums."""
    nb = 132 * 8 + 9
    rng = np.random.default_rng(11)
    n = nb * TILE - 100
    lo = rng.integers(0, 1000, n).astype(np.int32)
    run = np.where(rng.random(n) < 0.05, rng.integers(1, 9, n), 0)
    hi = (lo + run).astype(np.int32)
    qc = np.zeros(n, np.int32)
    q_occ = np.ones(n, np.int32)
    qp = rng.integers(0, 1 << 30, n).astype(np.int32)
    qs = rng.integers(0, 2, n).astype(np.int32)
    status, totals, lst = _kernel_b_scan(qc, q_occ, qp, qs, lo, hi, 8, _orders(nb)[order])
    words = _scan_words(qc, q_occ, lo, hi, 8)
    sums = np.array([words[b * TILE:(b + 1) * TILE].sum() for b in range(nb)], np.uint64)
    assert [x >> FLAG_SHIFT for x in status] == [FLAG_PREFIX] * nb
    assert [x & ((1 << FLAG_SHIFT) - 1) for x in status] == [int(v) for v in np.cumsum(sums)]
    assert totals == (int(run.sum()), int((run > 0).sum()))
    kept = np.flatnonzero(run > 0)
    assert np.array_equal(lst[0], lo[kept]) and np.array_equal(lst[1], np.cumsum(run)[kept] -
                                                                  run[kept])
    assert np.array_equal(lst[2], qp[kept]) and np.array_equal(lst[3], qs[kept])


@pytest.mark.parametrize("broken", ["status_flag", "look_back", "row_search"])
def test_kernel_b_with_a_broken_step_disagrees(broken):
    """A look-back that stops at an aggregate as if it were a prefix, one
    that leaves the prefix word's value out, and a row search that takes
    the lane before a run's first row each give other pairs."""
    args = _join(40 * TILE - 3, 20 * TILE, 10 * TILE, 21)
    want = ta.match_emit_plain(*(torch.from_numpy(x) for x in args), max_occ=8)
    order = _orders(40)["seeded_random"]
    got, _totals = _kernel_b(*args, max_occ=8, order=order)
    assert all(np.array_equal(w.numpy(), g) for w, g in zip(want, got))
    bad, _totals = _kernel_b(*args, max_occ=8, order=order, broken=broken)
    assert bad.shape != got.shape or not np.array_equal(bad, got)


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
