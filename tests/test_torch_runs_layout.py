"""PyTorch port: the schedule of the run-length kernel (csrc/runs.cu)
checked on the CPU, for both its instantiations (int32 keys; int64 pair
codes).

The kernel runs only on the card. What is checked here is a numpy
transcription of its schedule, with the constants read from the .cu (VEC
and ROUNDS from each key width's ``Keys<...>``): the tile of TILE entries a
block read as VEC-entry vectors in ROUNDS rounds (entry order round, warp,
lane, vector slot), each entry's carry word
(END_BIT at a run end, else its weight), the segmented sum of a thread's
entries, the warps' shuffle scans and the block's words in index order; the
two chained scans with decoupled look-back over windows of LOOKBACK
predecessors (the carry words, where a prefix or a word with a run end
stops the walk, then the exact survivor counts), for any order in which
the blocks finish; and the write launch, which reads each block's weight
in and survivor offset from the finished status words, writes the
survivors below the cap (keys of the input's width) and pads (SENTINEL,
or PAD64 for int64 keys) from the survivor count. The transcription is held exact to the plain
version (``run_scan_plain``, through ``run_scan`` + ``run_compact``) at
one block, a ragged last block, and a run open across more blocks than a
look-back window; a transcription whose look-back does not stop at a run
end, or whose carry is not reset there, must disagree.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from subphaser_torch.ops import count
from subphaser_torch.ops.kmer import SENTINEL
from subphaser_torch.ops.kmer_pair import PAD64
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SRC = Path(__file__).resolve().parents[1] / "subphaser_torch" / "csrc" / "runs.cu"
TEXT = SRC.read_text()


def _constants(text: str, names, known: dict) -> dict:
    out = dict(known)
    for name in names:
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert m, name
        value = eval(m.group(1).replace("/", "//"), {}, out)  # noqa: S307 (the .cu's constants)
        out[name] = int(value)
    return out


CONST = _constants(TEXT, ("THREADS", "WARPS", "TILE", "LOOKBACK", "FLAG_SHIFT",
                          "FLAG_AGGREGATE", "FLAG_PREFIX"), {})


def _key_constants(key: str) -> dict:
    """The constants with VEC and ROUNDS of the instantiation on ``key``
    (the .cu's ``struct Keys<key>``)."""
    m = re.search(rf"struct Keys<{key}> {{(.*?)\n}};", TEXT, re.S)
    assert m, key
    return _constants(m.group(1), ("VEC", "ROUNDS"), CONST)


INT32 = _key_constants("int32_t")
INT64 = _key_constants("long long")
assert re.search(r"constexpr u64 END_BIT = 1ull << 32;", TEXT)
assert re.search(r"constexpr u64 VALUE_MASK = 0xffffffffull;", TEXT)
END, MASK = np.uint64(1 << 32), np.uint64((1 << 32) - 1)
TILE, LOOKBACK = CONST["TILE"], CONST["LOOKBACK"]
SHIFT = CONST["FLAG_SHIFT"]


def combine(a, b):
    """The segmented sum of the .cu: range a followed by range b."""
    return np.where(b & END, b, (a & END) | ((a + b) & MASK))


def test_constants():
    for kc in (INT32, INT64):
        assert kc["TILE"] == kc["THREADS"] * kc["VEC"] * kc["ROUNDS"]
    assert INT32["VEC"] * 4 == INT64["VEC"] * 8 == 16  # one 16-byte load of keys
    assert CONST["WARPS"] * 32 == CONST["THREADS"] and LOOKBACK == 32
    assert {CONST["FLAG_AGGREGATE"], CONST["FLAG_PREFIX"]} == {1, 2} and SHIFT == 62


def _tiles(keys: np.ndarray, weights, broken: str, kc: dict):
    """Every block before its look-backs: the entries as (blocks, ROUNDS,
    WARPS, 32, VEC), their run ends and weights, each thread's carry word
    before its entries inside its warp, the warps' words before it inside
    the block, and the block's word."""
    n = keys.size
    nb = -(-n // TILE)
    idx = np.arange(nb * TILE)
    k = np.zeros(nb * TILE + 1, np.int64)
    k[:n] = keys
    w = np.zeros(nb * TILE, np.uint64)
    w[:n] = 1 if weights is None else weights
    end = (idx < n) & ((idx == n - 1) | (k[:-1] != k[1:]))
    elem = np.where(end, END, w) if broken != "no_reset" else w
    shape = (nb, kc["ROUNDS"], CONST["WARPS"], 32, kc["VEC"])
    e5, w5, end5, k5 = (x.reshape(shape) for x in (elem, w, end, k[:-1]))
    t = np.zeros(shape[:-1], np.uint64)
    for j in range(kc["VEC"]):
        t = combine(t, e5[..., j])
    inc = t.copy()
    lane = np.arange(32)
    d = 1
    while d < 32:  # the warp's shuffle scan
        up = np.zeros_like(inc)
        up[..., d:] = inc[..., :-d]
        inc = np.where(lane >= d, combine(up, inc), inc)
        d <<= 1
    excl = np.zeros_like(inc)
    excl[..., 1:] = inc[..., :-1]
    agg = np.zeros(nb, np.uint64)
    pre = np.zeros(shape[:3], np.uint64)
    for r in range(kc["ROUNDS"]):
        for v in range(CONST["WARPS"]):
            pre[:, r, v] = agg
            agg = combine(agg, inc[:, r, v, 31])
    return dict(nb=nb, k=k5, w=w5, end=end5, excl=excl, pre=pre, agg=agg, kc=kc,
                pair=keys.dtype == np.int64)


def _look_back(status: list, b: int, broken: str) -> int:
    """Warp 0's look-back from block b over published words."""
    before, pos = 0, b - 1
    while True:
        words = [status[pos - lane] if pos - lane >= 0 else 2 << SHIFT
                 for lane in range(LOOKBACK)]
        assert all(x >> SHIFT for x in words)  # every word before b is published here
        stop = [x >> SHIFT == CONST["FLAG_PREFIX"] or (x & (1 << 32) and broken != "no_end_stop")
                for x in words]
        last = stop.index(True) if any(stop) else LOOKBACK - 1
        before = (before + sum(x & ((1 << 32) - 1) for x in words[:last + 1])) & ((1 << 32) - 1)
        if any(stop):
            return before
        pos -= LOOKBACK


def _keeps(t: dict, b: int, cin: int, lower: int):
    """Block b's run totals and keep flags, by entry."""
    c = combine(combine(np.uint64(cin), t["pre"][b][..., None]), t["excl"][b])
    c = (c & MASK).astype(np.int64)
    tot = np.zeros(t["w"][b].shape, np.int64)
    kept = np.zeros(t["w"][b].shape, bool)
    key = t["k"][b]
    live = (key >> 31 if t["pair"] else key) != SENTINEL  # the pair's pad test: the hi word
    for j in range(t["kc"]["VEC"]):
        tot[..., j] = (c + t["w"][b][..., j].astype(np.int64)) & ((1 << 32) - 1)
        e = t["end"][b][..., j]
        kept[..., j] = (e & live[..., j] & (tot[..., j] >= lower)
                        & (tot[..., j] > 0) & (tot[..., j] < 1 << 31))
        c = np.where(e, 0, tot[..., j])
    return tot, kept


def transcribe(keys: np.ndarray, weights, lower: int, cap: int, order, broken: str = ""):
    pair = keys.dtype == np.int64
    t = _tiles(keys, weights, broken, INT64 if pair else INT32)
    nb = t["nb"]
    order = list(order(nb))
    carry = [(CONST["FLAG_PREFIX"] if b == 0 else CONST["FLAG_AGGREGATE"]) << SHIFT
             | int(t["agg"][b]) for b in range(nb)]  # every block publishes before it waits
    counts = [0] * nb
    cin = [0] * nb
    for b in order:  # the carry look-backs, in the order the blocks finish them
        cin[b] = 0 if b == 0 else _look_back(carry, b, broken)
        if b > 0:
            carry[b] = CONST["FLAG_PREFIX"] << SHIFT | int(combine(np.uint64(cin[b]),
                                                                   t["agg"][b]) & MASK)
    for b in order:
        kept = _keeps(t, b, cin[b], lower)[1]
        counts[b] = (CONST["FLAG_PREFIX"] if b == 0 else CONST["FLAG_AGGREGATE"]) << SHIFT \
            | int(kept.sum())
    for b in order:
        if b > 0:
            counts[b] = CONST["FLAG_PREFIX"] << SHIFT | (_look_back(counts, b, broken)
                                                         + (counts[b] & ((1 << 32) - 1)))
    m = counts[nb - 1] & ((1 << 32) - 1)  # the last block's prefix
    out_k = np.full(cap, -1, np.int64)
    out_t = np.full(cap, -1, np.int64)
    for b in range(max(nb, -(-cap // TILE))):  # the write launch
        lo, hi = max(m, b * TILE), min(cap, (b + 1) * TILE)
        out_k[lo:hi], out_t[lo:hi] = PAD64 if pair else SENTINEL, 0
        if b >= nb:
            continue
        soff = 0 if b == 0 else counts[b - 1] & ((1 << 32) - 1)
        cin_b = 0 if b == 0 else carry[b - 1] & ((1 << 32) - 1)
        if soff >= cap:
            continue
        tot, kept = _keeps(t, b, cin_b, lower)
        at = soff + np.cumsum(kept.reshape(-1)) - 1
        sel = kept.reshape(-1) & (at < cap)
        out_k[at[sel]] = t["k"][b].reshape(-1)[sel]
        out_t[at[sel]] = tot.reshape(-1)[sel]
    return out_k, out_t, m


def _plain(keys, weights, lower, cap):
    runs = count.run_scan(torch.from_numpy(keys),
                          None if weights is None else torch.from_numpy(weights), lower)
    got_keys, got_tot = count.run_compact(runs, cap)
    assert got_keys.shape == (cap,) and got_keys.dtype == runs.keys.dtype
    return got_keys.numpy(), got_tot.numpy(), int(runs.m)


def _case(name: str):
    rng = np.random.default_rng(len(name))
    if name == "one_block":
        keys = np.sort(rng.integers(0, 300, 1000)).astype(np.int32)
    elif name == "ragged":
        keys = np.sort(rng.integers(0, 4000, 3 * TILE + 77)).astype(np.int32)
        keys[-500:] = SENTINEL
    else:  # a run open across more blocks than a look-back window
        keys = np.sort(rng.integers(0, 20_000, 8 * TILE)).astype(np.int32)
        long = np.full((LOOKBACK + 3) * TILE + 9, 20_001, np.int32)
        keys = np.concatenate([keys[:4 * TILE], long, keys[4 * TILE:] + 20_002])
        keys[-TILE:] = SENTINEL
    weights = rng.integers(0, 4, keys.size).astype(np.int32)
    return keys, weights


def _case64(name: str):
    """The int32 case as pair codes: value v -> hi v // 2, lo (v + 1) // 2,
    so that neighbouring values differ in the lo word alone (v even) or in
    the hi word alone (v odd); SENTINEL -> PAD64, and in the ragged case a
    run of (SENTINEL, 5) before it: a pad by its hi word alone."""
    keys, weights = _case(name)
    v = keys.astype(np.int64)
    codes = np.where(keys == SENTINEL, PAD64, (v // 2) << 31 | (v + 1) // 2)
    if name == "ragged":
        codes[-500:-300] = SENTINEL << 31 | 5
    return codes, weights


def _check_schedule(keys, weights, lower, order):
    m_ref = _plain(keys, weights, lower, 1)[2]
    for cap in sorted({keys.size, max(m_ref, 1), max(m_ref // 2, 1)}):
        ref = _plain(keys, weights, lower, cap)
        got = transcribe(keys, weights, lower, cap, ORDERS[order])
        assert got[2] == ref[2] == m_ref
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1]), cap


ORDERS = {"ascending": range, "descending": lambda nb: range(nb - 1, -1, -1),
          "shuffled": lambda nb: np.random.default_rng(nb).permutation(nb)}


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("lower", [1, 3])
@pytest.mark.parametrize("name", ["one_block", "ragged", "long_run"])
def test_schedule_matches_plain(name, lower, weighted, order):
    keys, weights = _case(name)
    _check_schedule(keys, weights if weighted else None, lower, order)


@pytest.mark.parametrize("order", list(ORDERS))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("lower", [1, 3])
@pytest.mark.parametrize("name", ["one_block", "ragged", "long_run"])
def test_schedule64_matches_plain(name, lower, weighted, order):
    """The int64 instantiation (VEC and ROUNDS of ``Keys<long long>``) on
    pair codes whose runs differ in one word only, with pads by the hi word."""
    keys, weights = _case64(name)
    step = keys[1:] != keys[:-1]
    hi_same = (keys[1:] >> 31) == (keys[:-1] >> 31)
    lo_same = (keys[1:] & 0x7FFFFFFF) == (keys[:-1] & 0x7FFFFFFF)
    assert (step & hi_same).any() and (step & lo_same).any()
    _check_schedule(keys, weights if weighted else None, lower, order)


@pytest.mark.parametrize("broken", ["no_end_stop", "no_reset"])
def test_schedule_with_a_broken_step_disagrees(broken):
    keys, weights = _case("long_run")
    ref = _plain(keys, weights, 1, keys.size)
    got = transcribe(keys, weights, 1, keys.size, ORDERS["shuffled"], broken)
    assert got[2] != ref[2] or not np.array_equal(got[1], ref[1])


@pytest.mark.parametrize("broken", ["no_end_stop", "no_reset"])
def test_schedule64_with_a_broken_step_disagrees(broken):
    keys, weights = _case64("long_run")
    ref = _plain(keys, weights, 1, keys.size)
    got = transcribe(keys, weights, 1, keys.size, ORDERS["shuffled"], broken)
    assert got[2] != ref[2] or not np.array_equal(got[1], ref[1])
