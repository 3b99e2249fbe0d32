"""PyTorch port: (hi, lo) pair codes for k in [16, 31] against the JAX
package on the same packed tiles.

k covers both edges (16: the window's hi mask is empty and the reversal
shift is a whole word; 31: hi holds 31 value bits) and two middle values.
Tolerance: exact (int32 words, the SENTINEL pair included).
"""

import numpy as np
import pytest
import torch

from subphaser_torch.io.genome import PackedGenome
from subphaser_torch.ops import kmer_pair as tp
from subphaser_tpu.ops import kmer_pair as jp

KS = [16, 17, 23, 31]
FNS = ["kmer_codes_pair", "forward_codes_pair"]


def _both(fn, words, vwords, k, n_pos_words):
    ref = [np.asarray(a) for a in getattr(jp, fn)(words, vwords, k, n_pos_words)]
    got = [a.numpy() for a in getattr(tp, fn)(
        torch.from_numpy(words), torch.from_numpy(vwords), k, n_pos_words)]
    return ref, got


def _tiles(seed: int, k: int, tile_bases: int = 1 << 10):
    rng = np.random.default_rng(seed)
    seq = np.array(list("ACGT"))[rng.integers(0, 4, 5000)]
    for p in rng.integers(0, 4900, 8):  # N runs
        seq[p : p + rng.integers(1, 40)] = "N"
    seq[100:110] = list("acgtnACGTN")  # lower case + ambiguous
    g = PackedGenome.from_dict({"c1": "".join(seq), "c2": "".join(seq[:777])})
    return list(g.tiles(k, tile_bases=tile_bases)), tile_bases // 16


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("fn", FNS)
def test_pair_codes_bit_exact(k, fn):
    tiles, n_pos_words = _tiles(k, k)
    n_masked = 0
    for t in tiles:
        ref, got = _both(fn, t.words, t.vwords, k, n_pos_words)
        for r, g in zip(ref, got):
            assert g.dtype == np.int32 and g.shape == (16, n_pos_words)
            assert np.array_equal(g, r)
        # padding is the PAIR: hi == SENTINEL implies lo == SENTINEL here
        # (random sequence carries no T^15 prefix)
        assert np.array_equal(got[0] == tp.SENTINEL, got[1] == tp.SENTINEL)
        n_masked += int((got[0] == tp.SENTINEL).sum())
    assert n_masked > 0  # N runs / chromosome ends were masked


@pytest.mark.parametrize("k", KS)
def test_sign_bit_words(k):
    """Words with the top bit set (T at base 15): the arithmetic-shift trap."""
    words = np.full(10, -1, dtype=np.int32)  # all T
    words[::2] = np.int32(-0x55555556)  # alternating bases, sign bit set
    vwords = np.full(10, 0xFFFF, dtype=np.int32)
    for fn in FNS:
        ref, got = _both(fn, words, vwords, k, 8)
        assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
        assert (got[0] >= 0).all() and (got[1] >= 0).all()


def test_poly_t_run_at_k31():
    """A T run longer than k: forward codes reach hi == SENTINEL without
    being padding; exactly T^31 is the (SENTINEL, SENTINEL) pair."""
    rng = np.random.default_rng(31)
    seq = ("".join(np.array(list("ACGT"))[rng.integers(0, 4, 300)]) + "T" * 50
           + "".join(np.array(list("ACG"))[rng.integers(0, 3, 300)]))
    g = PackedGenome.from_dict({"c": seq})
    (tile,) = list(g.tiles(31, tile_bases=1 << 10))
    ref, got = _both("forward_codes_pair", tile.words, tile.vwords, 31, 64)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    hi = got[0].T.reshape(-1)[: len(seq) - 30]  # position order
    lo = got[1].T.reshape(-1)[: len(seq) - 30]
    t31 = (hi == tp.SENTINEL) & (lo == tp.SENTINEL)
    assert t31.sum() == 20 and t31[300:320].all()
    assert ((hi == tp.SENTINEL) & ~t31).sum() > 0  # T^15[GT].. windows
    ref, got = _both("kmer_codes_pair", tile.words, tile.vwords, 31, 64)
    assert np.array_equal(got[0], ref[0]) and np.array_equal(got[1], ref[1])
    # canonical codes never carry hi == SENTINEL on a valid position
    valid = np.ones(64 * 16, bool)
    valid[len(seq) - 30:] = False
    assert not (got[0].T.reshape(-1)[valid] == tp.SENTINEL).any()


@pytest.mark.parametrize("k", KS)
def test_combine_split_and_int64_form(k):
    tiles, n_pos_words = _tiles(k + 100, k)
    t = tiles[0]
    w, v = torch.from_numpy(t.words), torch.from_numpy(t.vwords)
    code = tp.kmer_codes64(w, v, k, n_pos_words)
    hi, lo = tp.kmer_codes_pair(w, v, k, n_pos_words)
    assert torch.equal(tp.combine64_t(hi, lo), code)
    assert code.max().item() == tp.PAD64
    assert np.array_equal(tp.combine64(hi.numpy(), lo.numpy()),
                          jp.combine64(hi.numpy(), lo.numpy()))
    for a, b in zip(tp.split64(code.numpy()), jp.split64(code.numpy())):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("k", [15, 32])
def test_k_out_of_range_raises(k):
    w = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tp.kmer_codes_pair(w, w, k, 2)
