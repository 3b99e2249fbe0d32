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


@pytest.mark.parametrize("n", [1, 37, 1024, 5000])
def test_sort_rle_identical(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 40, size=n).astype(np.int32)
    x[rng.random(n) < 0.2] = tc.SENTINEL
    ju, jn = (np.asarray(a) for a in jc.sort_rle(x))
    tu, tn = (a.numpy() for a in tc.sort_rle(torch.from_numpy(x)))
    assert np.array_equal(ju, tu) and np.array_equal(jn, tn)


@pytest.mark.parametrize("lower", [1, 3])
def test_merge_rle_many_identical(lower):
    rng = np.random.default_rng(lower)
    parts = [jc.sort_rle(rng.integers(0, 300, size=m).astype(np.int32))
             for m in (100, 257, 64)]
    ju, jn = (np.asarray(a) for a in jc.merge_rle_many(parts, lower))
    tparts = [tuple(torch.from_numpy(np.array(a)) for a in p) for p in parts]
    tu, tn = (a.numpy() for a in tc.merge_rle_many(tparts, lower))
    assert np.array_equal(ju, tu) and np.array_equal(jn, tn)


def test_async_cap_overflow_recounts_exactly():
    rng = np.random.default_rng(7)
    parts = [torch.from_numpy(rng.integers(0, 5000, size=3000).astype(np.int32))
             for _ in range(3)]
    ref = tc.count_codes_threshold(parts, 2)
    handles = tc.count_codes_async(parts, 2, static_cap=16)  # far too small
    got = tc.count_codes_collect(handles, 2, rebuild_parts=lambda: parts)
    assert np.array_equal(ref[0], got[0]) and np.array_equal(ref[1], got[1])
    jref = jc.count_codes_threshold([np.asarray(p) for p in parts], 2)
    assert np.array_equal(ref[0], jref[0]) and np.array_equal(ref[1], jref[1])


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
