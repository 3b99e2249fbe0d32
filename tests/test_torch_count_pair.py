"""PyTorch port: pair-code (k in [16, 31]) counting against the JAX package
on the same packed tiles. Tolerance: exact (int32 words, int64 host codes,
counts)."""

import numpy as np
import pytest
import torch

from subphaser_torch.ops import count_pair as tc
from subphaser_torch.phase.spectrum import count_genome as t_count_genome
from subphaser_torch.state import genome_from_numpy
from subphaser_tpu.io.genome import PackedGenome
from subphaser_tpu.ops import count_pair as jc
from subphaser_tpu.phase.spectrum import count_genome as j_count_genome
from tests.test_encoding import random_seq
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _t(a):
    return torch.from_numpy(np.array(a))


def _genome(seed: int, n_frac: float = 0.02):
    rng = np.random.default_rng(seed)
    unit = random_seq(rng, 150)
    return PackedGenome.from_dict(
        {"c": unit * 8 + random_seq(rng, 3000, n_frac=n_frac)})


def _same(jres, tres):
    for a, b in zip(jres, tres):
        b = b.numpy() if isinstance(b, torch.Tensor) else b
        assert np.asarray(a).dtype == b.dtype
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("k", [16, 17, 23, 31])
@pytest.mark.parametrize("batched", [False, True])
def test_count_tile_batch_pair_identical(k, batched):
    tiles = list(_genome(k).tiles(k, tile_bases=1024))
    if batched:
        words = np.stack([t.words for t in tiles[:3]])
        vwords = np.stack([t.vwords for t in tiles[:3]])
    else:
        words, vwords = tiles[1].words, tiles[1].vwords
    jres = jc.count_tile_batch_pair(words, vwords, k, 64)
    tres = tc.count_tile_batch_pair(_t(words), _t(vwords), k, 64)
    _same(jres, tres)
    assert int(tres[2].sum()) > 0
    _same(jc.extract_pair_codes_batch(words, vwords, k, 64),
          tc.extract_pair_codes_batch(_t(words), _t(vwords), k, 64))


@pytest.mark.parametrize("lower", [1, 3])
@pytest.mark.parametrize("k", [17, 31])
def test_count_pair_codes_threshold_identical(k, lower):
    tiles = list(_genome(k + lower).tiles(k, tile_bases=1024))
    jparts = [jc.extract_pair_codes_batch(t.words, t.vwords, k, 64) for t in tiles]
    tparts = [tuple(_t(np.asarray(a)) for a in p) for p in jparts]
    jcode, jn = jc.count_pair_codes_threshold(jparts, lower)
    tcode, tn = tc.count_pair_codes_threshold(tparts, lower)
    assert tcode.dtype == np.int64 and tn.dtype == np.int64 and tcode.size > 0
    assert np.array_equal(tcode, jcode) and np.array_equal(tn, jn)
    assert np.all(np.diff(tcode) > 0)
    assert tn.min() >= lower
    for fn in (jc.count_pair_codes_threshold, tc.count_pair_codes_threshold):
        code, n = fn([], lower)
        assert code.size == 0 and n.size == 0 and code.dtype == np.int64


@pytest.mark.parametrize("lower", [1, 3])
def test_merge_rle_many_pair_identical(lower):
    k = 19
    tiles = list(_genome(5).tiles(k, tile_bases=1024))
    jparts = [jc.count_tile_batch_pair(t.words, t.vwords, k, 64) for t in tiles]
    tparts = [tuple(_t(np.asarray(a)) for a in p) for p in jparts]
    _same(jc.merge_rle_many_pair(jparts, lower), tc.merge_rle_many_pair(tparts, lower))
    _same(jc.merge_rle_many_pair(jparts[:1], lower),
          tc.merge_rle_many_pair(tparts[:1], lower))


@pytest.mark.parametrize("lower", [1, 3])
@pytest.mark.parametrize("budget,tile,spills", [(1 << 28, 1024, False),
                                                (1 << 12, 1024, False),
                                                (1 << 10, 512, True)])
def test_accumulator_identical(budget, tile, spills, lower):
    """Without pre-merges, with device pre-merges, and with host spills."""
    k = 17
    g = _genome(9, n_frac=0.0)
    jacc = jc.PairSpectrumAccumulator(device_budget=budget)
    tacc = tc.PairSpectrumAccumulator(device_budget=budget)
    for t in g.tiles(k, tile_bases=tile):
        jacc.add(*jc.count_tile_batch_pair(t.words, t.vwords, k, tile // 16))
        tacc.add(*tc.count_tile_batch_pair(_t(t.words), _t(t.vwords), k, tile // 16))
        assert tacc.pending == jacc.pending
    assert bool(tacc.spilled) == bool(jacc.spilled) == spills
    jcode, jn = jacc.finish(lower)
    tcode, tn = tacc.finish(lower)
    assert tcode.dtype == np.int64 and tn.dtype == np.int64
    assert np.array_equal(tcode, jcode) and np.array_equal(tn, jn)
    assert np.all(np.diff(tcode) > 0) and tn.min() >= lower


@pytest.mark.parametrize(
    "device_budget,batch_tiles,lower_count",
    [
        (1 << 28, 1, 3),   # fast pair path: one sort per chromosome
        (1 << 28, 2, 1),   # fast pair path, batched extraction
        (1 << 15, 2, 3),   # accumulator path (pre-merges on device)
        (1 << 12, 1, 3),   # accumulator path with host spills
    ],
)
def test_pair_spectra_identical(tmp_path_factory, device_budget, batch_tiles, lower_count):
    from tests.make_synthetic import make_genome

    base = tmp_path_factory.mktemp("count_pair")
    fa, _cfg = make_genome(str(base), n_sets=2, chrom_size=30_000)
    jg, _ = PackedGenome.from_fasta_files([fa], workers=1)
    tg = genome_from_numpy((c.name, c.length, c.packed, c.vmask) for c in jg.chroms)
    kw = dict(lower_count=lower_count, tile_bases=1 << 14,
              device_budget=device_budget, batch_tiles=batch_tiles)
    js = j_count_genome(jg, 17, **kw)
    ts = t_count_genome(tg, 17, device="cpu", **kw)
    assert [s.name for s in js] == [s.name for s in ts]
    for a, b in zip(js, ts):
        assert a.total == b.total and b.codes.size > 0
        assert b.codes.dtype == np.int64 and b.counts.dtype == np.int64
        assert np.array_equal(a.codes, b.codes) and np.array_equal(a.counts, b.counts)
