"""PyTorch port: the run-length passes of int64 pair codes (k > 15).

``run_scan`` + ``run_compact`` of ops/count on int64 keys: on the CPU their
plain version against the two ``torch.cummax`` chains that counting used
before the kernel (run lengths of a batch, run totals of a merge's counts),
on the card the 64-bit instantiation of csrc/runs.cu (``rn_count64``,
``rn_write64``, int64 keys out, PAD64-padded) against the plain version, and
the launches and spans of counting on int64 keys. Its outputs are held to
the JAX package's pair codes by tests/test_torch_count_pair.py. The tests marked ``cuda`` skip without a
card. Tolerance: exact (integer keys, counts and survivor counts).
"""

import numpy as np
import pytest
import torch

from subphaser_torch.ops import count
from subphaser_torch.ops.kmer import SENTINEL
from subphaser_torch.ops.kmer_pair import PAD64
from subphaser_torch.utils.profiling import Spans
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TILE = 4096  # entries a block of csrc/runs.cu, either key width


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _pair_keys(n: int, pad_run: int, seed: int, device, top: bool = False) -> torch.Tensor:
    """Sorted pair codes: values v drawn as tests/test_torch_runs draws int32
    keys (runs of a few, runs of ~1,000 across tiles), mapped to hi = v // 2,
    lo = (v + 1) // 2, so that neighbouring values differ in the lo word
    alone (v even) or in the hi word alone (v odd); ``top`` lifts hi to end
    just under SENTINEL; then a PAD64 run of ``pad_run``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    short = torch.randint(0, max(n // 3, 1), (n - n // 4,), generator=gen, device=device)
    long = torch.randint(0, max(n // 4096, 1), (n // 4,), generator=gen, device=device) * 4099
    v = torch.sort(torch.cat([short, long])).values
    hi = v // 2
    if top:
        hi += SENTINEL - 1 - int(hi.max())
    keys = hi << 31 | (v + 1) // 2
    if pad_run:
        keys[n - pad_run:] = PAD64
    return keys


def _weights(n: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)
    return torch.randint(0, 4, (n,), generator=gen, device=device, dtype=torch.int32)


def _bounds(s):
    n = s.numel()
    start = torch.ones(n, dtype=torch.bool, device=s.device)
    start[1:] = s[1:] != s[:-1]
    end = torch.ones(n, dtype=torch.bool, device=s.device)
    end[:-1] = s[:-1] != s[1:]
    return start, end


def _cummax_lengths(s, lower: int):
    """The pair codes' run lengths before the kernel (a prefix maximum of the
    run starts), compacted."""
    start, end = _bounds(s)
    iota = torch.arange(s.numel(), dtype=torch.int32, device=s.device)
    runlen = iota - torch.cummax(torch.where(start, iota, -1), 0).values + 1
    keep = end & (runlen >= lower) & ((s >> 31) != SENTINEL)
    return s[keep], runlen[keep].to(torch.int32)


def _cummax_totals(code, counts, lower: int):
    """The pair codes' run totals of a merge before the kernel (after its
    sort), compacted."""
    start, end = _bounds(code)
    csum = torch.cumsum(counts, 0, dtype=torch.int64)
    run_tot = csum - torch.cummax(torch.where(start, csum - counts, -1), 0).values
    keep = end & (run_tot >= lower) & ((code >> 31) != SENTINEL) & (run_tot > 0)
    return code[keep], run_tot[keep].to(torch.int32)


CASES = {  # name -> (n, PAD64 run, top)
    "one_block": (1000, 0, False),
    "ragged": (3 * TILE + 77, 500, False),
    "long_pad_run": (12 * TILE, 7 * TILE + 5, False),
    "near_the_pad": (5 * TILE + 3, 40, True),
}


@pytest.mark.parametrize("lower", [1, 3])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_runs_of_pair_codes_equal_the_cummax_chains(name, weighted, lower):
    n, pad_run, top = CASES[name]
    keys = _pair_keys(n, pad_run, n + lower, "cpu", top)
    step = keys[1:] != keys[:-1]
    assert (step & ((keys[1:] >> 31) == (keys[:-1] >> 31))).any()  # lo word alone
    assert (step & ((keys[1:] & 0x7FFFFFFF) == (keys[:-1] & 0x7FFFFFFF))).any()  # hi alone
    weights = _weights(n, n, "cpu") if weighted else None
    if weighted:
        assert (weights == 0).any()
        want = _cummax_totals(keys, weights, lower)
    else:
        want = _cummax_lengths(keys, lower)
    got = count.run_scan_plain(keys, weights, lower)
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    runs = count.run_scan(keys, weights, lower)
    assert int(runs.m) == want[0].numel()
    for cap in (n, max(want[0].numel() // 2, 1)):
        out, tot = count.run_compact(runs, cap)
        assert out.shape == tot.shape == (cap,)
        assert out.dtype == torch.int64 and tot.dtype == torch.int32
        assert torch.equal(out, count._pad_to(want[0], cap, PAD64))
        assert torch.equal(tot, count._pad_to(want[1], cap, 0))


def test_plain_runs_drop_a_pad_by_its_hi_word_and_zero_totals():
    """(SENTINEL, 5) is a pad (the hi word alone decides); a run whose
    weights are all 0 does not survive at lower 1."""
    keys = torch.tensor([3 << 31 | 7, 3 << 31 | 7, 3 << 31 | 8, 4 << 31 | 8,
                         SENTINEL << 31 | 5, PAD64, PAD64])
    weights = torch.tensor([1, 2, 0, 5, 9, 9, 9], dtype=torch.int32)
    got = count.run_scan_plain(keys, weights, 1)
    assert got[0].tolist() == [3 << 31 | 7, 4 << 31 | 8] and got[1].tolist() == [3, 5]
    got = count.run_scan_plain(keys, None, 2)
    assert got[0].tolist() == [3 << 31 | 7] and got[1].tolist() == [2]


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_runs64_wrapper_refuses_bad_inputs(device):
    if device == "cuda":
        _card()
    keys = torch.arange(64, dtype=torch.int64, device=device)
    with pytest.raises(ValueError, match="contiguous"):
        count.run_scan(keys[::2], None, 1)
    with pytest.raises(ValueError, match="1-D"):
        count.run_scan(keys.reshape(8, 8), None, 1)
    with pytest.raises(ValueError, match="weights"):
        count.run_scan(keys, keys, 1)  # int64 weights
    with pytest.raises(ValueError, match="weights"):
        count.run_scan(keys, torch.ones(32, dtype=torch.int32, device=device), 1)
    with pytest.raises(ValueError, match="weights"):
        count.run_scan(keys, torch.ones(128, dtype=torch.int32, device=device)[::2], 1)


def _pair_parts(device, n_parts: int = 4, n: int = 2000):
    """Batches of random int64 pair codes, hi = v // 2, lo = (v + 1) // 2."""
    rng = np.random.default_rng(20)
    parts = []
    for _ in range(n_parts):
        v = torch.from_numpy(rng.integers(0, 3000, n)).to(device)
        parts.append((v // 2) << 31 | (v + 1) // 2)
    return parts


def _accumulate(device):
    """SpectrumAccumulator over four batches of int64 keys (``sort_rle``)
    with a budget that merges twice on the way and once at the end: (spans,
    host codes, counts)."""
    rec = Spans()
    with rec.job(torch.device(device)):
        with rec.span("count"):
            acc = count.SpectrumAccumulator(device_budget=5000)
            for keys in _pair_parts(device):
                acc.add(*count.sort_rle(keys))
            codes, counts = acc.finish(lower_count=2)
    return rec, codes, counts


def _want_spectrum(lower: int):
    v = np.concatenate([keys.numpy() for keys in _pair_parts("cpu")])
    codes, counts = np.unique(v, return_counts=True)
    return codes[counts >= lower], counts[counts >= lower]


def test_cpu_pair_path_launches_nothing_and_records_its_spans():
    before = dict(count.entry_launches)
    rec, codes, counts = _accumulate("cpu")
    assert count.entry_launches == before and rec.launches == {}
    assert {"count/runs", "count/compact", "count/merge"} <= set(rec.calls)
    assert rec.calls["count/runs"] == 4 and rec.calls["count/merge"] == 3
    want = _want_spectrum(2)
    assert np.array_equal(codes, want[0]) and np.array_equal(counts, want[1])


@pytest.mark.cuda
def test_cuda_pair_path_launches_the_64_bit_entries():
    """Each batch and each merge launches rn_count64 and rn_write64 once,
    counted by the wrapper and in the job's launches; no int32 entry."""
    _card()
    before = dict(count.entry_launches)
    rec, codes, counts = _accumulate("cuda")
    passes = rec.calls["count/runs"] + rec.calls["count/merge"]
    assert (rec.calls["count/runs"], rec.calls["count/merge"]) == (4, 3)
    assert rec.launches == {"rn_count64": passes, "rn_write64": passes}
    launched = {e: count.entry_launches[e] - before[e] for e in before}
    assert launched == {"rn_count": 0, "rn_write": 0, "rn_count64": passes,
                        "rn_write64": passes}
    want = _want_spectrum(2)
    assert np.array_equal(codes, want[0]) and np.array_equal(counts, want[1])


def _check_card(keys, weights, lower, caps=None):
    """Kernel against plain on the card at the given caps (the fixed cap n,
    or the survivor count's power-of-two cap), with the launches counted."""
    before = dict(count.entry_launches)
    runs = count.run_scan(keys, weights, lower)
    m = int(runs.m)
    n = keys.numel()
    kept_k, kept_t = count.run_scan_plain(keys, weights, lower)
    assert m == kept_k.numel()
    for cap in caps or (n, count._out_cap(m, n)):
        out, tot = count.run_compact(runs, cap)
        torch.cuda.synchronize()
        assert out.shape == (cap,) and out.dtype == torch.int64, cap
        assert torch.equal(out, count._pad_to(kept_k, cap, PAD64)), cap
        assert torch.equal(tot, count._pad_to(kept_t, cap, 0)), cap
    assert count.entry_launches["rn_count64"] == before["rn_count64"] + 1
    assert count.entry_launches["rn_write64"] > before["rn_write64"]
    assert count.entry_launches["rn_count"] == before["rn_count"]


@pytest.mark.cuda
@pytest.mark.parametrize("lower", [1, 3])
def test_cuda_runs64_at_a_batch_of_2_to_24_keys(lower):
    """A low-memory batch: 2^24 pair codes, run lengths, cap n."""
    _card()
    n = 1 << 24
    _check_card(_pair_keys(n, n // 100, 24 + lower, "cuda"), None, lower, caps=(n,))


@pytest.mark.cuda
def test_cuda_runs64_at_a_merge_of_2_to_28_weighted_entries():
    """A merge: 2^28 weighted entries, lower 1, cap from the survivor count."""
    _card()
    n = 1 << 28
    keys = _pair_keys(n, n // 100, 28, "cuda")
    weights = _weights(n, 28, "cuda")
    runs = count.run_scan(keys, weights, 1)
    _check_card(keys, weights, 1, caps=(count._out_cap(int(runs.m), n),))


@pytest.mark.cuda
def test_cuda_runs64_at_the_fast_path_of_2_to_27_keys():
    """The fast path (``count_codes_threshold`` on int64 keys, one 80 Mb
    chromosome a sort): 2^27 pair codes, lower 3, a PAD64 run of 2^27 - 80,000,000,
    cap from the survivor count."""
    _card()
    n = 1 << 27
    keys = _pair_keys(n, n - 80_000_000, 27, "cuda")
    runs = count.run_scan(keys, None, 3)
    _check_card(keys, None, 3, caps=(count._out_cap(int(runs.m), n),))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, TILE - 1, TILE, TILE + 1, 3 * TILE + 5])
def test_cuda_runs64_edge_shapes(n):
    """Tiny arrays, sizes around a tile, one run over the whole array, all
    PAD64, keys just under the pad, and an unaligned view."""
    _card()
    one = torch.full((n,), 7 << 31 | 3, dtype=torch.int64, device="cuda")
    pads = torch.full((n,), PAD64, dtype=torch.int64, device="cuda")
    for keys in (_pair_keys(n, 0, n, "cuda"), _pair_keys(n, n // 3, n, "cuda", top=True),
                 one, pads):
        for weights in (None, _weights(n, n, "cuda")):
            _check_card(keys, weights, 1)
            _check_card(keys, weights, n + 1)  # above every total
    view = _pair_keys(n + 1, 0, n, "cuda")[1:]
    assert view.data_ptr() % 16
    _check_card(view, None, 1)
