"""PyTorch port: ops/anchors (hash-sampled anchors of a tile and of a whole
chromosome, the device join of two anchor sets) against the JAX package's,
on the same seeded sequences; the port on the CPU, where ``sampled_anchors``
and ``match_emit`` take their plain versions.

Tolerance: exact. Codes, positions, strands, counts and joined pairs are
integers, compared element for element and in order. Tests marked ``cuda``
hold the kernels (csrc/anchors.cu) to their plain versions on the card and
skip without one; they import nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from subphaser_torch.io.genome import PackedGenome, tile_words_for
from subphaser_torch.ops import anchors as ta
from subphaser_torch.ops.kmer import SENTINEL
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TILE = 1 << 12


def random_seq(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), size=n))


def _genome_seqs(seed: int = 5) -> dict[str, str]:
    """A chromosome with N runs (invalid k-mers) and a partial last tile,
    and one that is N for its first two tiles."""
    rng = np.random.default_rng(seed)
    a = list(random_seq(rng, 3 * TILE + 777))
    for s, n in ((100, 7), (2000, 40), (5000, 333)):
        a[s : s + n] = ["N"] * n
    b = "N" * (2 * TILE) + random_seq(rng, TILE // 2)
    return {"a": "".join(a), "b": b}


@pytest.fixture(scope="module")
def jax_anchors():
    from subphaser_tpu.ops import anchors

    return anchors


@pytest.fixture(scope="module")
def genomes():
    from subphaser_tpu.io.genome import PackedGenome as JaxGenome

    seqs = _genome_seqs()
    return JaxGenome.from_dict(seqs), PackedGenome.from_dict(seqs)


def _tile(chrom, start: int, k: int):
    n_words = tile_words_for(TILE, k)
    return ta._tile_words(chrom, start, n_words)


@pytest.mark.parametrize("mod", [16, 8])
@pytest.mark.parametrize("chrom,start,cap", [
    ("a", 0, 1 << 12),          # a whole tile with N runs
    ("a", 3 * TILE, 1 << 12),   # the chromosome's partial last tile
    ("b", TILE, 1 << 12),       # a tile of invalid words only
    ("a", TILE, 37),            # a cap below the count
])
def test_sampled_anchors_matches_jax(jax_anchors, genomes, mod, chrom, start, cap):
    import jax.numpy as jnp

    _jg, tg = genomes
    k = 15
    words, vwords = _tile(tg.chrom(chrom), start, k)
    kw = dict(k=k, n_pos_words=TILE // 16, mod=mod, cap=cap)
    want = jax_anchors.sampled_anchors(jnp.asarray(words), jnp.asarray(vwords), **kw)
    got = ta.sampled_anchors(torch.from_numpy(words), torch.from_numpy(vwords), **kw)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    n = int(got[3])
    if chrom == "b":
        assert n == 0
    elif cap < 1 << 12:
        assert n > cap and (got[0].numpy() != SENTINEL).all()
    else:
        assert 0 < n < cap and (got[0][n:].numpy() == SENTINEL).all()


@pytest.mark.parametrize("k,mod", [(15, 16), (13, 4)])
def test_chrom_anchors_match_jax(jax_anchors, genomes, k, mod):
    """The port's device anchors, in order, for every chromosome: equal to
    the JAX host variant and to the valid entries of the JAX device
    variant."""
    jg, tg = genomes
    for name in ("a", "b"):
        want = jax_anchors.chrom_anchors(jg.chrom(name), k=k, mod=mod, tile_bases=TILE)
        td = ta.chrom_anchors_dev(tg.chrom(name), k=k, mod=mod, tile_bases=TILE, device="cpu")
        assert td.n == td.c.numel() == want[0].size
        for w, g in zip(want, (td.c, td.p, td.s)):
            assert np.array_equal(w, g.numpy())
        jd = jax_anchors.chrom_anchors_dev(jg.chrom(name), k=k, mod=mod, tile_bases=TILE)
        assert td.n == jd.n
        jc = np.asarray(jd.c)
        keep = jc != SENTINEL
        for w, g in zip((jc, np.asarray(jd.p), np.asarray(jd.s)), (td.c, td.p, td.s)):
            assert np.array_equal(w[keep], g.numpy())


def _pair_seqs(seed: int = 21):
    """tests/test_blocks.py::test_device_match_equals_host_match's pair:
    shared core, a repeat, and a high-occurrence repeat."""
    rng = np.random.default_rng(seed)
    core = random_seq(rng, 40_000)
    rep = random_seq(rng, 700)
    return {"q": core[:20_000] + rep + core[20_000:] + rep,
            "t": rep + core[5_000:35_000] + rep + rep}


@pytest.mark.parametrize("max_occ", [8, 1])
def test_match_anchors_dev_matches_jax_and_host(jax_anchors, max_occ):
    from subphaser_tpu.io.genome import PackedGenome as JaxGenome

    seqs = _pair_seqs()
    jg, tg = JaxGenome.from_dict(seqs), PackedGenome.from_dict(seqs)
    k, mod, tb = 13, 4, 1 << 14
    jq, jt = (jax_anchors.chrom_anchors_dev(jg.chrom(n), k=k, mod=mod, tile_bases=tb)
              for n in ("q", "t"))
    want = jax_anchors.match_anchors_dev(jq, jt, max_occ=max_occ)
    qa, tt_ = (ta.chrom_anchors_dev(tg.chrom(n), k=k, mod=mod, tile_bases=tb, device="cpu")
               for n in ("q", "t"))
    got = ta.match_anchors_dev(qa, tt_, max_occ=max_occ)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and np.array_equal(w, g)
    assert got[0].size > 0
    hq, ht, hr = jax_anchors.match_anchors(
        *jax_anchors.chrom_anchors(jg.chrom("q"), k=k, mod=mod, tile_bases=tb),
        *jax_anchors.chrom_anchors(jg.chrom("t"), k=k, mod=mod, tile_bases=tb),
        max_occ=max_occ)
    order = np.lexsort((ht, hq))
    for h, g in zip((hq[order], ht[order], hr[order]), got):
        assert np.array_equal(h, g)


def test_anchor_cap_escalation_retry():
    """chrom_anchors_dev escalates its per-tile cap (not truncate) when the
    sampled-anchor density blows past the estimate (tests/test_blocks.py's
    case: poly-A samples every position)."""
    n = 1 << 16
    g = PackedGenome.from_dict({"c": "A" * (n + 64)})
    dev = ta.chrom_anchors_dev(g.chroms[0], k=15, mod=16, tile_bases=n, device="cpu")
    qc, qp = dev.c.numpy(), dev.p.numpy()
    assert dev.n == qc.size >= n
    assert np.all(qc == 0)
    assert np.array_equal(np.sort(qp), np.arange(qc.size))  # every start, no repeat


def _join_inputs(n_q: int, n_t: int, n_codes: int, seed: int):
    """Random query anchors and a code-sorted target, as match_anchors_dev
    hands them to match_emit."""
    rng = np.random.default_rng(seed)
    qc = rng.integers(0, n_codes, n_q).astype(np.int32)
    qc[rng.random(n_q) < 0.05] = SENTINEL
    tc = np.sort(rng.integers(0, n_codes, n_t)).astype(np.int32)
    t = [torch.from_numpy(x) for x in (tc, rng.integers(0, 1 << 30, n_t).astype(np.int32),
                                       rng.integers(0, 2, n_t).astype(np.int32))]
    q = [torch.from_numpy(x) for x in (qc, rng.integers(0, 1 << 30, n_q).astype(np.int32),
                                       rng.integers(0, 2, n_q).astype(np.int32))]
    qsort = torch.sort(q[0]).values
    lo, hi = ta._ss_left_right(qsort, q[0])
    q_occ = hi - lo
    lo, hi = ta._ss_left_right(t[0], q[0])
    return q[0], q_occ, q[1], q[2], t[1], t[2], lo, hi


@pytest.mark.parametrize("case", ["random", "none_kept", "all_max_occ"])
def test_match_emit_plain_against_host_join(case):
    """match_emit's plain version gives the pairs of a host join (a loop
    over each kept run, written independently), in csum order."""
    max_occ = 8
    if case == "random":
        args = _join_inputs(5000, 6000, 3000, 3)
    elif case == "none_kept":
        args = _join_inputs(500, 600, 100_000, 4)
        args = args[:6] + (args[6], args[6])  # every run empty
    else:
        # every code occurs exactly max_occ times in the target, once in the query
        tc = np.repeat(np.arange(400, dtype=np.int32), max_occ)
        qc = np.random.default_rng(5).permutation(400).astype(np.int32)
        tp = np.arange(tc.size, dtype=np.int32)
        ts = (tp % 3 == 0).astype(np.int32)
        qp = np.arange(400, dtype=np.int32) * 7
        qs = (qp % 2).astype(np.int32)
        lo, hi = ta._ss_left_right(torch.from_numpy(tc), torch.from_numpy(qc))
        args = (torch.from_numpy(qc), torch.ones(400, dtype=torch.int32), torch.from_numpy(qp),
                torch.from_numpy(qs), torch.from_numpy(tp), torch.from_numpy(ts), lo, hi)
    got = ta.match_emit(*args, max_occ=max_occ)
    qc, q_occ, qp, qs, tp_s, ts_s, lo, hi = (x.numpy() for x in args)
    runs = hi - lo
    keep = (runs > 0) & (runs <= max_occ) & (q_occ <= max_occ) & (qc != SENTINEL)
    want_q, want_t, want_r = [], [], []
    for i in np.flatnonzero(keep):
        for j in range(lo[i], hi[i]):
            want_q.append(qp[i])
            want_t.append(tp_s[j])
            want_r.append(int(qs[i] != ts_s[j]))
    for w, g in zip((want_q, want_t, want_r), got):
        assert g.dtype == torch.int32 and np.array_equal(np.asarray(w, np.int32), g.numpy())
    if case == "none_kept":
        assert got[0].numel() == 0
    if case == "all_max_occ":
        assert got[0].numel() == 400 * max_occ


def test_wrappers_refuse_other_devices():
    x = torch.zeros(300, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        ta.sampled_anchors(x, x, k=15, n_pos_words=16, mod=16, cap=64)
    with pytest.raises(ValueError, match="device"):
        ta.match_emit(x, x, x, x, x, x, x, x, max_occ=8)
    with pytest.raises(ValueError):
        ta.sampled_anchors(torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=torch.int32),
                           k=15, n_pos_words=16, mod=16, cap=64)  # no halo word


@pytest.mark.cuda
@pytest.mark.parametrize("start,cap", [(0, 1 << 12), (3 * TILE, 1 << 12), (TILE, 37)])
def test_cuda_sampled_anchors_matches_plain(start, cap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seqs = _genome_seqs()
    g = PackedGenome.from_dict(seqs)
    words, vwords = _tile(g.chrom("a"), start, 15)
    kw = dict(k=15, n_pos_words=TILE // 16, mod=16, cap=cap)
    before = ta.launches["sampled_anchors"]
    entry = ta.entry_launches["an_sampled_anchors"]
    got = ta.sampled_anchors(torch.from_numpy(words).cuda(), torch.from_numpy(vwords).cuda(),
                             **kw)
    torch.cuda.synchronize()
    want = ta.sampled_anchors_plain(torch.from_numpy(words), torch.from_numpy(vwords), **kw)
    assert ta.launches["sampled_anchors"] == before + 1
    assert ta.entry_launches["an_sampled_anchors"] == entry + 1
    for w, x in zip(want, got):
        assert torch.equal(w, x.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("W,mod,cap", [(5000, 16, 1 << 14), (5000, 16, 100),
                                       (1 << 19, 16, 1 << 20), ((1 << 20) + 3, 4, 1 << 22),
                                       ((1 << 21) + 5, 1, 1 << 24)])
def test_cuda_sampled_anchors_random_tiles(W, mod, cap):
    """Kernel A on random tiles of one block, of several, of the path's
    2^19 words (512 blocks) and of more than A_MAX_BLOCKS runs of 4 rounds
    (17 rounds a block at 2^21 words: the counters are emptied mid-run, and
    mod 1 takes every valid k-mer); caps above the count and below a
    block's first slot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(W)
    words = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, W + 1).astype(np.int32))
    vwords = torch.from_numpy((rng.random(W + 1) < 0.99).astype(np.int32) * 0xFFFF)
    kw = dict(k=15, n_pos_words=W, mod=mod, cap=cap)
    got = ta.sampled_anchors(words.cuda(), vwords.cuda(), **kw)
    want = ta.sampled_anchors_plain(words.cuda(), vwords.cuda(), **kw)
    torch.cuda.synchronize()
    for w, x in zip(want, got):
        assert torch.equal(w, x)


@pytest.mark.cuda
def test_cuda_match_emit_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _join_inputs(50_000, 60_000, 30_000, 9)
    want = ta.match_emit_plain(*args, max_occ=8)
    before = ta.launches["match_emit"]
    got = ta.match_emit(*(x.cuda() for x in args), max_occ=8)
    torch.cuda.synchronize()
    assert ta.launches["match_emit"] == before + 1
    for w, x in zip(want, got):
        assert torch.equal(w, x.cpu())


@pytest.mark.cuda
def test_cuda_match_emit_at_path_shapes():
    """Kernel B at the blocks path's shapes (5 M anchors a side, ~5% of
    the queries kept, ~2,400 blocks of the scan): the plain version's
    pairs, one counted launch, one call of each C entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [x.cuda() for x in _join_inputs(5_000_000, 5_000_000, 100_000_000, 14)]
    want = ta.match_emit_plain(*args, max_occ=8)
    before = ta.launches["match_emit"]
    entries = {e: ta.entry_launches[e] for e in ("an_match_scan", "an_match_emit")}
    got = ta.match_emit(*args, max_occ=8)
    torch.cuda.synchronize()
    assert ta.launches["match_emit"] == before + 1
    assert all(ta.entry_launches[e] == n + 1 for e, n in entries.items())
    assert want[0].numel() > 100_000
    for w, x in zip(want, got):
        assert torch.equal(w, x)
