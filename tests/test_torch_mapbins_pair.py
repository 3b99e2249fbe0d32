"""PyTorch port: pair-code (k in [16, 31]) bin mapping against the JAX
package on the same genome and significant-k-mer table. Tolerance: exact
(int bin counts, hit lists, distinct-hit count)."""

import numpy as np
import pytest
import torch

from subphaser_torch.ops import mapbins_pair as tm
from subphaser_torch.ops.kmer_pair import split64
from subphaser_torch.state import genome_from_numpy
from subphaser_tpu.io.encoding import kmer_code
from subphaser_tpu.io.genome import PackedGenome
from subphaser_tpu.ops import mapbins_pair as jm
from tests.oracle import revcomp
from tests.test_encoding import random_seq

BIN, N_SG, TILE = 128, 2, 1024


def _sig_table(seq, k, positions, extra=()):
    d_kmers = {}
    for pos in positions:
        kmer = seq[pos : pos + k]
        if "N" in kmer or len(kmer) < k or set(kmer) == {"T"}:
            continue
        sg = (pos // 700) % N_SG
        d_kmers[kmer] = sg
        d_kmers[revcomp(kmer)] = sg
    for kmer in extra:
        d_kmers[kmer] = 1
        d_kmers[revcomp(kmer)] = 1
    codes = np.array(sorted(kmer_code(s) for s in d_kmers), dtype=np.int64)
    sgs = np.array([d_kmers[s] for s in sorted(d_kmers, key=kmer_code)], dtype=np.int32)
    return codes, sgs


def _cases():
    rng = np.random.default_rng(5)
    seq19 = random_seq(rng, 4000, n_frac=0.01)
    rng = np.random.default_rng(7)
    seq31 = (random_seq(rng, 900, n_frac=0.0) + "T" * 50
             + random_seq(rng, 1200, n_frac=0.0))
    return {
        19: (seq19, *_sig_table(seq19, 19, range(0, 3500, 53))),
        # a sig k-mer overlapping the poly-T run (hi == SENTINEL form)
        31: (seq31, *_sig_table(seq31, 31, range(0, 1800, 61), [seq31[890:921]])),
    }


@pytest.mark.parametrize("k", [19, 31])
def test_map_genome_bins_pair_identical(k):
    seq, codes, sgs = _cases()[k]
    jg = PackedGenome.from_dict({"c": seq})
    tg = genome_from_numpy((c.name, c.length, c.packed, c.vmask) for c in jg.chroms)
    jacc = jm.map_genome_bins_pair(jg, codes, sgs, k, TILE, BIN, N_SG)
    tacc = tm.map_genome_bins_pair(tg, codes, sgs, k, TILE, BIN, N_SG, device="cpu")
    assert np.array_equal(tacc.per_chrom[0], jacc.per_chrom[0])
    assert tacc.per_chrom[0].sum() > 0
    assert tacc.mapped_positions == jacc.mapped_positions
    assert tacc.mapped_kmer_count == jacc.mapped_kmer_count > 0
    assert tm.max_hi_run(codes) == jm.max_hi_run(codes)


@pytest.mark.parametrize("k", [19, 31])
def test_map_tile_bins_pair_identical(k):
    """Per tile: bin counts, first bin and the sorted distinct sig-table
    indices (the JAX probe loop and the port's one int64 search agree)."""
    seq, codes, sgs = _cases()[k]
    g = PackedGenome.from_dict({"c": seq})
    sig_hi, sig_lo = split64(codes)
    kw = dict(k=k, n_pos_words=TILE // 16, bin_size=BIN, n_sg=N_SG,
              nbins_tile=TILE // BIN + 2)
    n_hit = 0
    for t in g.tiles(k, tile_bases=TILE):
        jb, jf, jh = jm.map_tile_bins_pair(
            t.words, t.vwords, sig_hi, sig_lo, sgs, np.int32(t.start),
            probe=max(jm.max_hi_run(codes), 1), **kw)
        tb, tf, th = tm.map_tile_bins_pair(
            torch.from_numpy(t.words), torch.from_numpy(t.vwords),
            torch.from_numpy(codes), torch.from_numpy(sgs), t.start, **kw)
        assert np.array_equal(tb.numpy(), np.asarray(jb)) and tf == int(jf)
        assert th.dtype == torch.int32 and np.array_equal(th.numpy(), np.asarray(jh))
        n_hit += int(tb.sum())
    assert n_hit > 0


def test_poly_t_window_is_skipped_and_its_neighbours_hit():
    """k = 31: a T^31 code in the table never hits (it aliases the pad
    pair); windows with hi == SENTINEL that are not T^31 do."""
    seq, codes, sgs = _cases()[31]
    t31 = kmer_code("T" * 31)
    a31 = kmer_code("A" * 31)
    codes2 = np.concatenate([codes, [a31, t31]])
    sgs2 = np.concatenate([sgs, [0, 0]]).astype(np.int32)
    order = np.argsort(codes2)
    codes2, sgs2 = codes2[order], sgs2[order]
    g = genome_from_numpy((c.name, c.length, c.packed, c.vmask)
                          for c in PackedGenome.from_dict({"c": seq}).chroms)
    base = tm.map_genome_bins_pair(g, codes, sgs, 31, TILE, BIN, N_SG, device="cpu")
    more = tm.map_genome_bins_pair(g, codes2, sgs2, 31, TILE, BIN, N_SG, device="cpu")
    assert more.mapped_positions == base.mapped_positions
    assert more.mapped_kmer_count == base.mapped_kmer_count
    assert base.per_chrom[0][890 // BIN, 1] > 0
