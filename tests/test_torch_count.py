"""PyTorch port: sort/RLE counting, spectra and the differential filter
against the JAX package on the same inputs. Tolerance: exact (int codes and
counts; the filter's float64 host arithmetic is a copy)."""

import numpy as np
import pytest
import torch

from subphaser_torch.ops import count as tc
from subphaser_torch.phase.spectrum import count_genome as t_count_genome
from subphaser_torch.state import genome_from_numpy, spectra_from_numpy
from subphaser_tpu.ops import count as jc
from subphaser_tpu.phase.spectrum import count_genome as j_count_genome
from tests.make_synthetic import make_genome
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    from subphaser_tpu.io.genome import PackedGenome

    base = tmp_path_factory.mktemp("count")
    fa, _cfg = make_genome(str(base), n_sets=3, chrom_size=40_000)
    jg, _ = PackedGenome.from_fasta_files([fa], workers=1)
    tg = genome_from_numpy((c.name, c.length, c.packed, c.vmask) for c in jg.chroms)
    return jg, tg


def _same_spectra(js, ts):
    assert [s.name for s in js] == [s.name for s in ts]
    for a, b in zip(js, ts):
        assert a.total == b.total
        assert b.codes.dtype == np.int32 and b.counts.dtype == np.int64
        assert np.array_equal(a.codes, b.codes)
        assert np.array_equal(a.counts, b.counts)


@pytest.mark.parametrize(
    "device_budget,batch_tiles,lower_count",
    [
        (1 << 28, 1, 3),    # fast path, one keys-only sort per chromosome
        (1 << 28, 2, 1),    # fast path, batched extraction, no threshold
        (1 << 15, 1, 3),    # accumulator path (pre-merges on device)
        (1 << 15, 2, 2),    # accumulator path, batched tiles
        (1 << 12, 1, 3),    # accumulator path with host spills
    ],
)
def test_spectra_identical(genomes, device_budget, batch_tiles, lower_count):
    jg, tg = genomes
    kw = dict(lower_count=lower_count, tile_bases=1 << 14,
              device_budget=device_budget, batch_tiles=batch_tiles)
    js = j_count_genome(jg, 15, **kw)
    ts = t_count_genome(tg, 15, device="cpu", **kw)
    _same_spectra(js, ts)


def test_spectrum_checkpoint_resumes_across_packages(genomes, tmp_path):
    from subphaser_torch.utils.checkpoint import Checkpoint as TC
    from subphaser_tpu.utils.checkpoint import Checkpoint as JC

    jg, tg = genomes
    kw = dict(lower_count=3, tile_bases=1 << 14)
    js = j_count_genome(jg, 15, checkpoint=JC(str(tmp_path)), **kw)
    ts = t_count_genome(tg, 15, checkpoint=TC(str(tmp_path)), device="cpu", **kw)
    _same_spectra(js, ts)


def test_k_above_15_not_ported(genomes):
    """Nothing above k = 15 is left unported: k = 16 and 31 count as pair
    codes (int64 on the host) and equal the JAX package's spectra."""
    jg, tg = genomes
    for k in (16, 31):
        js = j_count_genome(jg, k, lower_count=2, tile_bases=1 << 14)
        ts = t_count_genome(tg, k, lower_count=2, tile_bases=1 << 14, device="cpu")
        for a, b in zip(js, ts):
            assert b.codes.dtype == np.int64 and a.total == b.total > 0
            assert np.array_equal(a.codes, b.codes) and np.array_equal(a.counts, b.counts)


TILE = 4096  # keys a block of the run kernel (csrc/runs.cu)


def _codes(n: int, kind: str, seed: int) -> np.ndarray:
    """``random``: 40 values and 20% SENTINEL; ``one_run``: one value
    throughout; ``all_sentinel``; ``long_runs``: runs of ~1,000, across the
    run kernel's tiles, and 5% SENTINEL."""
    rng = np.random.default_rng(seed)
    if kind == "one_run":
        return np.full(n, 7, np.int32)
    if kind == "all_sentinel":
        return np.full(n, tc.SENTINEL, np.int32)
    x = rng.integers(0, 40 if kind == "random" else max(n // 1000, 1), size=n).astype(np.int32)
    x[rng.random(n) < (0.2 if kind == "random" else 0.05)] = tc.SENTINEL
    return x


@pytest.mark.parametrize("n,kind", [
    (1, "random"), (2, "random"), (37, "random"), (1024, "random"), (5000, "random"),
    (TILE - 1, "random"), (TILE, "random"), (TILE + 1, "random"),
    (2, "one_run"), (TILE + 1, "one_run"), (1, "all_sentinel"), (TILE + 1, "all_sentinel"),
    (3 * TILE + 5, "long_runs"),
])
def test_sort_rle_identical(n, kind):
    x = _codes(n, kind, n)
    ju, jn = (np.asarray(a) for a in jc.sort_rle(x))
    tu, tn = (a.numpy() for a in tc.sort_rle(torch.from_numpy(x)))
    assert np.array_equal(ju, tu) and np.array_equal(jn, tn)


@pytest.mark.parametrize("lower,kind", [
    (1, "random"), (3, "random"),
    (10_000, "random"),     # above every total
    (1, "zero_counts"),     # runs of zero counts are dropped (total > 0)
    (2, "long_runs"),       # runs across the run kernel's tiles
])
def test_merge_rle_many_identical(lower, kind):
    rng = np.random.default_rng(lower)
    hi = 300 if kind != "long_runs" else 4
    sizes = (100, 257, 64) if kind != "long_runs" else (TILE + 1, 2 * TILE - 1, 64)
    parts = [jc.sort_rle(rng.integers(0, hi, size=m).astype(np.int32)) for m in sizes]
    if kind == "zero_counts":
        parts = [(u, np.where(np.asarray(u) % 3 == 0, 0, np.asarray(c)).astype(np.int32))
                 for u, c in parts]
    ju, jn = (np.asarray(a) for a in jc.merge_rle_many(parts, lower))
    tparts = [tuple(torch.from_numpy(np.array(a)) for a in p) for p in parts]
    tu, tn = (a.numpy() for a in tc.merge_rle_many(tparts, lower))
    assert np.array_equal(ju, tu) and np.array_equal(jn, tn)


@pytest.mark.parametrize("lower,kind", [
    (2, "random"), (1, "one_run"), (2, "all_sentinel"),
    (10_000, "random"),     # above every count
    (2, "long_runs"),
])
def test_async_cap_overflow_recounts_exactly(lower, kind):
    parts = [torch.from_numpy(_codes(3000, kind, 7 + i)) for i in range(3)]
    if kind == "random":
        rng = np.random.default_rng(7)
        parts = [torch.from_numpy(rng.integers(0, 5000, size=3000).astype(np.int32))
                 for _ in range(3)]
    ref = tc.count_codes_threshold(parts, lower)
    handles = tc.count_codes_async(parts, lower, static_cap=16)  # far too small
    got = tc.count_codes_collect(handles, lower, rebuild_parts=lambda: parts)
    assert np.array_equal(ref[0], got[0]) and np.array_equal(ref[1], got[1])
    jref = jc.count_codes_threshold([np.asarray(p) for p in parts], lower)
    assert np.array_equal(ref[0], jref[0]) and np.array_equal(ref[1], jref[1])


def test_no_route_of_counting_or_mapping_takes_cummax(genomes, monkeypatch):
    """Counting at k 15 by the fast path and the accumulator path (a tiny
    device budget: pre-merges on device) and mapping's hit sets, with
    torch.cummax made to raise: no route still calls the scan."""
    from subphaser_torch.ops.mapbins import HitSet

    def refuse(*_a, **_k):
        raise AssertionError("torch.cummax called")

    jg, tg = genomes
    kw = dict(lower_count=3, tile_bases=1 << 14)
    js = j_count_genome(jg, 15, **kw)
    monkeypatch.setattr(torch, "cummax", refuse)
    monkeypatch.setattr(torch.Tensor, "cummax", refuse)
    for budget in (1 << 28, 1 << 15):
        _same_spectra(js, t_count_genome(tg, 15, device="cpu", device_budget=budget, **kw))
    hits = HitSet(budget=1 << 10, device="cpu")
    rng = np.random.default_rng(3)
    parts = [np.unique(rng.integers(0, 5000, size=800)).astype(np.int32) for _ in range(4)]
    for p in parts:
        hits.add(p)
    assert hits.count() == np.unique(np.concatenate(parts)).size
    assert np.array_equal(hits.snapshot(), np.unique(np.concatenate(parts)))


def test_build_matrix_identical(genomes):
    from subphaser_torch.phase.spectrum import build_matrix as t_build
    from subphaser_tpu.phase.spectrum import build_matrix as j_build

    js = j_count_genome(genomes[0], 15, lower_count=2, tile_bases=1 << 14)
    ts = spectra_from_numpy((s.name, s.codes, s.counts, s.total) for s in js)
    for lo, hi in ((1, float("inf")), (6, 40)):
        jm, tm = j_build(js, lo, hi), t_build(ts, lo, hi)
        assert tm.labels == jm.labels and tm.codes.size > 0
        for name in ("codes", "counts", "tot", "lengths", "freqs"):
            assert np.array_equal(getattr(tm, name), getattr(jm, name)), name


def test_streaming_filter_identical(genomes):
    from subphaser_torch.ops.filter import make_group_spec as t_spec
    from subphaser_torch.phase.filtering import streaming_filter as t_filter
    from subphaser_tpu.ops.filter import make_group_spec as j_spec
    from subphaser_tpu.phase.filtering import streaming_filter as j_filter

    jg, _ = genomes
    js = j_count_genome(jg, 15, lower_count=2, tile_bases=1 << 14)
    ts = spectra_from_numpy((s.name, s.codes, s.counts, s.total) for s in js)
    gi = [[[0], [1]], [[2], [3]], [[4], [5]]]
    kw = dict(min_freq=5, max_freq=1e9, min_fold=2.0, ratio=1.0, baseline=1, chunk=1 << 12)
    jr = j_filter(js, j_spec(gi, 6), **kw)
    tr = t_filter(ts, t_spec(gi, 6), **kw)
    assert tr.n_differential == jr.n_differential > 0
    assert np.array_equal(tr.matrix.codes, jr.matrix.codes)
    assert np.array_equal(tr.matrix.counts, jr.matrix.counts)
    assert np.array_equal(tr.fold_tots, jr.fold_tots)
