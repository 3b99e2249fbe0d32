"""PyTorch port: the Fisher tail's kernels (csrc/stats.cu) transcribed and
checked on the CPU.

The kernels run only on the card. What is checked here is a float32 torch
transcription of them, with the constants read from the .cu: a walk's
carry-free values (x = a + i, the ratio, its validity and logf of it,
computed a step of UNROLL terms ahead), the chain (log_term's add, then
logaddexp) in the JAX step's order, the three kinds of stop (the end: an
invalid term, a -inf log term or max_terms terms, checked at every term;
after a step's last term, log_sum >= 0 and the gap after a falling ratio,
(ULP_BITS - E) ln 2 + 1e-3 where |log_sum| >= 2^ULP_EXP_MIN, else
EXIT_GAP), and the scheduling: the first pass's FIRST_TERMS terms a table,
the queue's front (LONG_TERMS or more terms ahead) and back, and the queue
pass's warps handing POOL tickets at a time to their idle lanes. The walk
runs over whole tensors with the tables that stopped held as they are, so
every table's float32 operations go through the same CPU code paths as in
``fisher_right_tail_plain``; it must equal the plain version bit for bit
(NaN where it is NaN) on tables that reach each stop, and a copy whose gap
is 10 must not.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from subphaser_torch.ops import stats as ts
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SRC = Path(__file__).resolve().parents[1] / "subphaser_torch" / "csrc" / "stats.cu"
TEXT = SRC.read_text()


CONST: dict = {}


def _const(name: str):
    m = re.search(rf"constexpr (int|float) {name} = ([^;]+);", TEXT)
    assert m, name
    expr = m.group(2).replace("1.0f", "1.0")
    value = eval(expr, {}, CONST)  # noqa: S307 (the .cu's constants)
    CONST[name] = np.float32(value) if m.group(1) == "float" else int(value)
    return CONST[name]


THREADS, WARPS, UNROLL, FIRST_TERMS, LONG_TERMS, PAIRS, QUEUE_THREADS, POOL = (
    _const(n) for n in ("THREADS", "WARPS", "UNROLL", "FIRST_TERMS", "LONG_TERMS", "PAIRS",
                        "QUEUE_THREADS", "POOL"))
EXIT_GAP, ULP_BITS, ULP_EXP_MIN = (_const(n) for n in ("EXIT_GAP", "ULP_BITS", "ULP_EXP_MIN"))
RATIO_EXIT = _const("RATIO_EXIT")
LN2 = np.float32(0.6931472)

# stop kinds
END, CAP, POSITIVE, GAP_ULP, GAP_150 = 1, 2, 3, 4, 5


def test_constants():
    assert WARPS * 32 == THREADS and QUEUE_THREADS == 64 * PAIRS and POOL == 32
    assert RATIO_EXIT == np.float32(1 - 2.0 ** -16)
    assert ULP_BITS == 25 and EXIT_GAP == 150
    # the ulp rule's gap stays below EXIT_GAP, and 2^ULP_EXP_MIN is a normal float
    assert (ULP_BITS - ULP_EXP_MIN) * math.log(2) < EXIT_GAP and ULP_EXP_MIN > -126
    assert 0 < FIRST_TERMS < LONG_TERMS and FIRST_TERMS % UNROLL == 0 and UNROLL <= 32


def _exit_gap(s: torch.Tensor, gap: float | None = None, ulp_exp_min: int = ULP_EXP_MIN):
    """exit_gap: (ULP_BITS - E) ln 2 + 1e-3 from s's exponent field where
    ulp_exp_min <= E <= 127, else EXIT_GAP (a broken copy: ``gap``)."""
    if gap is not None:
        return torch.full_like(s, gap)
    e = ((s.view(torch.int32) >> 23) & 0xFF) - 127
    ulp = ((ULP_BITS - e).to(torch.float32) * float(LN2) + 1e-3).clamp_min(0.0)
    return torch.where((e < ulp_exp_min) | (e > 127), float(EXIT_GAP), ulp)


def _walk(a, b, c, d, max_terms: int = 16384, gap: float | None = None,
          ulp_exp_min: int = ULP_EXP_MIN):
    """Both kernels' walks, table by table in lockstep: (p, terms summed,
    stop kind) of every table. A step adds UNROLL terms, each guarded by
    the end (an invalid term, a -inf log term, max_terms terms); the
    positive sum and the gap are checked after a step's last term."""
    m = a + b + c + d
    n1 = a + b
    k1 = a + c
    upper = torch.minimum(n1, k1)
    mk = m - n1 - k1
    lp0 = ts._lpmf_hypergeom(a, m, n1, k1)
    s, t = lp0.clone(), lp0.clone()
    i = torch.zeros(a.shape, dtype=torch.int32)
    stop = torch.zeros(a.shape, dtype=torch.int8)
    active = torch.full(a.shape, max_terms > 0)

    def values(i):  # term_values
        x = a + i.to(torch.float32)
        x1 = x + 1.0
        ratio = ((n1 - x) * (k1 - x)) / (x1 * (mk + x + 1.0))
        valid = (x < upper) & (ratio > 0)
        return x1, ratio, valid, torch.log(ratio.clamp_min(1e-38))

    x1, ratio, valid, lr = values(i)
    while bool(active.any()):
        t_new = t + lr
        end = active & (~valid | (t_new == -math.inf))
        go = active & ~end
        s = torch.where(go, torch.logaddexp(s, t_new), s)
        t = torch.where(go, t_new, t)
        decreasing = (ratio <= float(RATIO_EXIT)) & (x1 > 0)
        i = i + go.to(torch.int32)
        x1, ratio, valid, lr = values(i)  # the next term's, beside the chain
        cap = go & (i >= max_terms)
        checked = go & ~cap & (i % UNROLL == 0)  # a step's last term
        positive = checked & (s >= 0)
        g = _exit_gap(s, gap, ulp_exp_min)
        gapped = checked & ~positive & decreasing & (s - t > g)
        by_150 = gapped & (g == float(EXIT_GAP))
        for mask, kind in ((end, END), (cap, CAP), (positive, POSITIVE),
                           (gapped & ~by_150, GAP_ULP), (by_150, GAP_150)):
            stop[mask] = kind
        active &= ~(end | cap | positive | gapped)
    p = torch.exp(s)
    return torch.where(a > upper, 0.0, p).clamp(0.0, 1.0), i, stop


def _same(x, y) -> bool:
    """Bit for bit, NaN where NaN."""
    return bool(torch.equal(x.isnan(), y.isnan())
                and torch.equal(x.nan_to_num(7.0).view(torch.int32),
                                y.nan_to_num(7.0).view(torch.int32)))


def _bins(rows: int, seed: int, scale: float = 1.0):
    """A bin-count matrix like phase main's (three SGs, hits a bin from 0 to
    a few thousand, skewed) and its enrichment tables."""
    rng = np.random.default_rng(seed)
    mean = rng.lognormal(3.0, 1.4, (rows, 1)) * scale
    share = rng.dirichlet([0.6, 0.6, 0.6], rows)
    counts = rng.poisson(mean * share * 3)
    return tuple(t.reshape(-1) for t in ts.enrich_tables(torch.from_numpy(counts)))


def _cells(*rows):
    return tuple(torch.tensor(col, dtype=torch.float32) for col in zip(*rows))


TABLES = {
    # a far above its expectation: a falling ratio from the first term
    "enriched": (_cells((60, 40, 90, 20000), (300, 10, 500, 100000), (30, 2, 80, 9000)),
                 16384, GAP_ULP),
    # a below its expectation: the walk climbs past the mode to log_sum >= 0
    # or to the gap
    "depleted": (_cells((2, 300, 400, 600), (10, 990, 1500, 2500), (0, 50, 60, 40)),
                 16384, POSITIVE),
    "cut_at_max_terms": (_cells((2, 300, 400, 600), (10, 990, 1500, 2500)), 40, CAP),
    "a_above_upper": (_cells((5, -2, 1, 7), (3, 0, 2, 9), (0, 4, 3, 0)), 16384, END),
    "nan_cell": (_cells((float("nan"), 3, 4, 5), (4, float("nan"), 4, 5), (1, 2, 3, 4)),
                 16384, END),
    "bins": (_bins(300, 1), 16384, GAP_ULP),
}


@pytest.mark.parametrize("case", list(TABLES))
def test_walk_matches_plain_bit_for_bit(case):
    cells, max_terms, kind = TABLES[case]
    want = ts.fisher_right_tail_plain(*cells, max_terms)
    got, terms, stop = _walk(*cells, max_terms=max_terms)
    assert _same(got, want)
    assert bool((stop == kind).any()), stop
    assert bool((terms <= max_terms).all())
    if case == "nan_cell":
        assert bool(got[:2].isnan().all()) and not bool(got[2].isnan())
    if case == "a_above_upper":
        assert got[0] == 0.0 and terms[0] == 0


def test_every_stop_kind_on_bin_tables():
    """Tables like a genome's bins reach the end, the positive sum and the
    gap; with the ulp rule off, the 150 gap alone, and both equal the
    plain version."""
    cells = _bins(400, 2)
    want = ts.fisher_right_tail_plain(*cells)
    got, terms, stop = _walk(*cells)
    assert _same(got, want)
    assert {END, POSITIVE, GAP_ULP} <= set(stop.tolist())
    only_150, terms_150, stop_150 = _walk(*cells, ulp_exp_min=128)
    assert _same(only_150, want) and GAP_150 in set(stop_150.tolist())
    assert int(terms.sum()) < int(terms_150.sum())  # the ulp rule stops sooner


def test_walks_stop_before_the_end():
    """The stops save terms against walks to the end (min(upper - a,
    max_terms) terms a table, cut at the first invalid term)."""
    cells = _bins(400, 3, scale=4.0)
    _p, terms, _stop = _walk(*cells)
    a, b, c, _d = cells
    to_end = torch.clamp(torch.minimum(b, c), 0, 16384)  # upper - a
    assert bool((terms <= to_end).all())
    assert int(terms.sum()) < 0.8 * int(to_end.sum())


def test_a_gap_of_10_disagrees():
    """A gap of 10 drops terms that still move the float32 sum."""
    cells = _bins(300, 1)
    want = ts.fisher_right_tail_plain(*cells)
    broken, _terms, _stop = _walk(*cells, gap=10.0)
    assert not _same(broken, want)
    assert _same(_walk(*cells)[0], want)


def _schedule(calls: np.ndarray, max_terms: int, upper_minus_a: np.ndarray, warps: int):
    """The first pass's split and the queue pass's consumer warps, from each
    table's terms looked at (its terms, and one more where it ends at an
    invalid or -inf term): which tables queue (and at which end), and, warp
    by warp in turn and step by step, each lane adding a step of UNROLL
    terms of its table (but for the step after it took the table, which its
    producer computed for its last one), then tickets handed POOL at a time
    to the idle lanes. Returns ((ticket, table) in the order they were
    handed out, the tables each lane ran, lane-steps with no table while the
    queue had tickets, the front's size, the steps each warp ran)."""
    n = calls.size
    queued = calls > FIRST_TERMS
    ahead = np.minimum(upper_minus_a, max_terms) - FIRST_TERMS
    front = [k for k in range(n) if queued[k] and ahead[k] >= LONG_TERMS]
    back = [k for k in range(n) if queued[k] and ahead[k] < LONG_TERMS]
    # the queue array: the front from 0 up, the back from n - 1 down
    queue = np.full(n, -1)
    queue[:len(front)] = front
    queue[n - 1 - np.arange(len(back))] = back
    total = len(front) + len(back)
    tickets = 0
    lanes = [[None] * 32 for _ in range(warps)]   # [table, steps left, skip]
    pools = [[0, 0, False] for _ in range(warps)]  # pool, pool end, drained
    done = [False] * warps
    steps = [0] * warps
    ran = [[[] for _ in range(32)] for _ in range(warps)]
    order, idle_while_queued = [], 0
    while not all(done):
        for w in range(warps):
            if done[w]:
                continue
            steps[w] += 1
            for ln in range(32):  # add a step, unless the producer's is for the last table
                lane = lanes[w][ln]
                if lane is not None:
                    if lane[2]:
                        lane[2] = False
                    else:
                        lane[1] -= 1
                        if lane[1] <= 0:
                            lanes[w][ln] = None
            pool = pools[w]
            idle = [ln for ln in range(32) if lanes[w][ln] is None]
            while idle and not pool[2]:
                if pool[0] == pool[1]:
                    base, tickets = tickets, tickets + POOL
                    pool[0], pool[1] = min(base, total), min(base + POOL, total)
                    pool[2] = pool[0] == pool[1]
                    if pool[2]:
                        break
                take = min(len(idle), pool[1] - pool[0])
                for rank, ln in enumerate(idle[:take]):
                    j = pool[0] + rank
                    table = queue[j if j < len(front) else n - 1 - (j - len(front))]
                    lanes[w][ln] = [table, -(-(calls[table] - FIRST_TERMS) // UNROLL), True]
                    ran[w][ln].append(table)
                    order.append((j, table))
                pool[0] += take
                idle = [ln for ln in range(32) if lanes[w][ln] is None]
            if tickets < total:
                idle_while_queued += len(idle)
            done[w] = all(lane is None for lane in lanes[w])  # the warp quits
    return order, ran, idle_while_queued, len(front), steps


def test_queue_schedule():
    """Every queued table runs once, on one lane; the front's long tables
    are handed out before any of the back's; no lane is idle while the
    queue holds tickets."""
    cells = _bins(600, 4, scale=3.0)
    _p, terms, stop = _walk(*cells)
    a, b, c, _d = cells
    upper_minus_a = (torch.minimum(a + b, a + c) - a).numpy()
    calls = (terms + (stop == END).to(torch.int32)).numpy()
    order, ran, idle_while_queued, n_front, steps = _schedule(calls, 16384, upper_minus_a,
                                                              warps=3)
    queued = np.flatnonzero(calls > FIRST_TERMS)
    assert queued.size > 3 * 32 and n_front > 0
    tickets = sorted(j for j, _table in order)
    assert tickets == list(range(queued.size))  # each ticket once
    assert sorted(table for _j, table in order) == queued.tolist()  # each table once
    for j, table in order:  # the front's tickets, the lowest, are the long tables
        assert (j < n_front) == (min(upper_minus_a[table], 16384) - FIRST_TERMS >= LONG_TERMS)
    assert idle_while_queued == 0
    # a lane's steps: each of its tables' steps, one skipped after each table
    # taken, and the warp runs until its last lane is done
    per_lane = [sum(1 + -(-(calls[t] - FIRST_TERMS) // UNROLL) for t in x) for w in ran for x in w]
    assert max(steps) == max(per_lane) + 1  # step 0 hands out the first tickets
    assert sum(len(x) for w in ran for x in w) == queued.size


@pytest.mark.cuda
def test_cuda_fisher_kernel_bit_for_bit_at_path_shapes():
    """Both kernels on tables like a 480 Mb genome's bins (47,470 x 3, long
    walks among them): the plain version's p values bit for bit, one
    counted launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cells = [t.cuda() for t in _bins(47_470, 5, scale=4.0)]
    before = ts.launches["fisher_right_tail"]
    got = ts.fisher_right_tail(*cells)
    want = ts.fisher_right_tail_plain(*cells)
    torch.cuda.synchronize()
    assert ts.launches["fisher_right_tail"] == before + 1
    assert _same(got, want)
