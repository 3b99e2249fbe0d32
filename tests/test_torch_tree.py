"""PyTorch port: ltr/tree (sketch-pair counts, Mash distances, newick
parsing and midpoint rerooting, build_ltr_trees on both routes) against
the JAX package's, on the same seeded numpy inputs; the port on the CPU,
where ``inter_counts`` takes its plain version.

Tolerance: exact. The counts are integers; the distances are the same
float64 host arithmetic over them; trees and files are compared as strings
and bytes. Tests marked ``cuda`` hold the kernel (csrc/tree_counts.cu) to
its plain version on the card and skip without one; they import nothing of
the JAX package (the card's machine has no JAX).
"""

import numpy as np
import pytest
import torch

from subphaser_torch.ltr import classify as tc
from subphaser_torch.ltr import tree as tt
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BIG = np.iinfo(np.int32).max


def _sketches(seed: int, n: int, sizes=(1, 256)) -> list[np.ndarray]:
    """``n`` bottom-s style sketches (sorted unique uint64) drawn from a
    shared pool so pairs share values; sizes in [sizes[0], sizes[1]]."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(0, 2**64 - 1, size=600, dtype=np.uint64))
    out = []
    for _ in range(n):
        k = int(rng.integers(sizes[0], sizes[1] + 1))
        out.append(np.sort(rng.choice(pool, size=min(k, pool.size), replace=False)))
    return out


def _padded(sketches):
    """The (n, s) int32 matrix mash_distances builds."""
    s = max(x.size for x in sketches)
    pad = np.full((len(sketches), s), BIG, dtype=np.int32)
    for i, x in enumerate(sketches):
        v = np.unique((x >> np.uint64(33)).astype(np.int32))
        pad[i, : v.size] = v
    return pad


@pytest.fixture(scope="module")
def jt():
    from subphaser_tpu.ltr import tree

    return tree


@pytest.fixture(scope="module")
def jc():
    from subphaser_tpu.ltr import classify

    return classify


@pytest.fixture(scope="module")
def jax_inter_counts(jt):
    """The JAX package's jitted ``inter_counts`` (nested in mash_distances),
    caught as mash_distances jits it."""
    import jax

    caught = []
    real_jit = jax.jit

    def spy(fn, *args, **kwargs):
        jitted = real_jit(fn, *args, **kwargs)
        if getattr(fn, "__name__", "") == "inter_counts":
            caught.append(jitted)
        return jitted

    jax.jit = spy
    try:
        jt.mash_distances(_sketches(0, 2))
    finally:
        jax.jit = real_jit
    assert len(caught) == 1
    return caught[0]


@pytest.mark.parametrize("sizes", [(1, 40), (100, 255), (256, 256)])
def test_inter_counts_plain_matches_jax(jax_inter_counts, sizes):
    sk = _sketches(sum(sizes), 24, sizes)
    sk[4] = sk[4][:1]  # a one-value sketch
    sk[7] = sk[3].copy()  # an identical pair
    pad = _padded(sk)
    if sizes[1] < 256:
        pad[5, -1] = BIG  # INT32_MAX as a real value counts in neither package
    ai, bi = np.triu_indices(len(sk), 1)
    want = np.asarray(jax_inter_counts(pad[ai], pad[bi]))
    before = dict(tt.launches)
    got = tt.inter_counts(torch.from_numpy(pad), torch.from_numpy(ai), torch.from_numpy(bi))
    assert tt.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert want.max() > 0


@pytest.mark.parametrize("case", ["mixed", "with_empty", "all_empty", "one"])
def test_mash_distances_equal(jt, case):
    sk = {"mixed": _sketches(1, 40),
          "with_empty": _sketches(2, 9, (1, 30)) + [np.zeros(0, np.uint64)],
          "all_empty": [np.zeros(0, np.uint64)] * 3,
          "one": _sketches(3, 1)}[case]
    got, want = tt.mash_distances(sk, device="cpu"), jt.mash_distances(sk)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_mash_distances_pair_chunks(monkeypatch):
    """Pairs go to inter_counts in chunks of PAIR_CHUNK; a small chunk gives
    the same matrix."""
    sk = _sketches(4, 30)
    want = tt.mash_distances(sk, device="cpu")
    monkeypatch.setattr(tt, "PAIR_CHUNK", 7)
    assert np.array_equal(tt.mash_distances(sk, device="cpu"), want)


def test_one_sketch_copy():
    assert tt._sketch is tc._sketch and tt.SKETCH_K == tc.SKETCH_K


def _nj_newick():
    from subphaser_torch.ltr.native import nj_tree

    rng = np.random.default_rng(9)
    x = rng.normal(size=(9, 4))
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    return nj_tree(d, [f"n{i}" for i in range(9)])


@pytest.mark.parametrize("which", ["caterpillar", "nj"])
def test_parse_newick_and_reroot_identical(jt, which):
    nwk = "((A:1,B:2):3,(C:2,D:6):1);" if which == "caterpillar" else _nj_newick()
    assert tt._to_newick(tt.parse_newick(nwk)) == jt._to_newick(jt.parse_newick(nwk))
    assert tt.reroot_midpoint(nwk) == jt.reroot_midpoint(nwk)


def test_reroot_midpoint():
    """tests/test_ltr.py::test_reroot_midpoint, on the port."""
    root = tt.parse_newick(tt.reroot_midpoint("((A:1,B:2):3,(C:2,D:6):1);"))
    assert len(root.children) == 2
    d = {}

    def rec(m, depth):
        depth += m.length
        if not m.children:
            d[m.name] = depth
        for c in m.children:
            rec(c, depth)

    for c in root.children:
        rec(c, 0.0)
    assert abs(d["B"] - 6.0) < 1e-6 and abs(d["D"] - 6.0) < 1e-6, d
    assert max(d.values()) <= 6.0 + 1e-6, d


# ---------------------------------------------------------------------------
# build_ltr_trees, both routes (tests/test_ltr.py::test_domain_tree_grouping)
# ---------------------------------------------------------------------------
class FakeLTR:
    def __init__(self, id, sg, seq, superfamily="Copia"):
        self.id, self.sg, self.seq = id, sg, seq
        self.superfamily = superfamily
        self.exchange = "no"
        self.seq_id = "c1"

    def get_full_seq(self, _chrom_seq):
        return self.seq


def _tree_inputs(seed=11):
    """Two clades of 5 elements with INT/RT/RH peptides and whole-element
    DNA, one element without domains, ids with ':' (renamed in newick)."""
    rng = np.random.default_rng(seed)
    aas = "ACDEFGHIKLMNPQRSTVWY"

    def mutate(p, rate, alphabet):
        return "".join(rng.choice([c for c in alphabet if c != ch]) if rng.random() < rate
                       else ch for ch in p)

    bases = {sg: ("".join(rng.choice(list(aas), 240)), "".join(rng.choice(list("ACGT"), 1500)))
             for sg in ("SG1", "SG2")}
    ltrs, doms = [], {}
    for i in range(5):
        for sg, (pep, dna) in bases.items():
            lid = f"c1:{sg}_{i}"
            ltrs.append(FakeLTR(lid, sg, mutate(dna, 0.05, "ACGT")))
            doms[lid] = {"INT": mutate(pep[:80], 0.05, aas), "RT": mutate(pep[80:160], 0.05, aas),
                         "RH": mutate(pep[160:], 0.05, aas)}
    ltrs.append(FakeLTR("c1:SG1_nodom", "SG1", mutate(bases["SG1"][1], 0.05, "ACGT")))
    ltrs.append(FakeLTR("c1:x", "SG2", bases["SG2"][1], superfamily="Gypsy"))  # a group of 1
    return ltrs, doms


def _classes(mod, doms, ltrs):
    return {ltr.id: mod.Classification(id=ltr.id, order="LTR", superfamily=ltr.superfamily,
                                       domain_seqs=doms.get(ltr.id))
            for ltr in ltrs}


@pytest.mark.parametrize("route", ["domains", "sketches"])
def test_build_ltr_trees_identical_files(jt, jc, tmp_path, route):
    ltrs, doms = _tree_inputs()
    kw = dict(domains=["INT", "RT", "RH"], d_colors={"SG1": "#f00", "SG2": "#00f"},
              figfmt="png", n_boot=20)
    outs = {}
    for name, mod, cls_mod, extra in (("j", jt, jc, {}), ("t", tt, tc, {"device": "cpu"})):
        d_class = _classes(cls_mod, doms, ltrs) if route == "domains" else None
        outs[name] = mod.build_ltr_trees(ltrs, {"c1": ""}, str(tmp_path / name),
                                         d_class=d_class, **kw, **extra)
    assert set(outs["t"]) == set(outs["j"]) == {"Copia"}
    suffixes = [".tree.nwk", ".tree.map"] + ([".aln", ".trimal"] if route == "domains" else [])
    for suffix in suffixes:
        got = (tmp_path / f"t.Copia{suffix}").read_bytes()
        assert got == (tmp_path / f"j.Copia{suffix}").read_bytes(), suffix
    assert (tmp_path / "t.Copia.aln").exists() == (route == "domains")
    nwk = (tmp_path / "t.Copia.tree.nwk").read_text()
    assert "c1:" not in nwk and "c1_SG2_0" in nwk  # ':' in ids is renamed
    assert ("c1_SG1_nodom" in nwk) == (route == "sketches")
    root = tt.parse_newick(nwk)

    def leaves(n):
        return [n.name] if not n.children else [x for c in n.children for x in leaves(c)]

    sides = [{("SG1" in x) for x in leaves(c)} for c in root.children]
    assert any(len(s) == 1 for s in sides), sides


def test_build_ltr_trees_subsamples_and_sorts(jt, tmp_path):
    """-subsample picks members with the seeded generator and keeps their
    order (the sketch route; both packages)."""
    ltrs, _doms = _tree_inputs()
    for name, mod, extra in (("j", jt, {}), ("t", tt, {"device": "cpu"})):
        mod.build_ltr_trees(ltrs, {"c1": ""}, str(tmp_path / name), subsample=6,
                            figfmt="png", **extra)
    got = (tmp_path / "t.Copia.tree.map").read_text()
    assert got == (tmp_path / "j.Copia.tree.map").read_text()
    assert len(got.splitlines()) == 6


def test_inter_counts_refuses_bad_input():
    pad = torch.zeros((3, 4), dtype=torch.int32)
    idx = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        tt.inter_counts(pad.long(), idx, idx)
    with pytest.raises(ValueError, match="int64"):
        tt.inter_counts(pad, idx.int(), idx)
    with pytest.raises(ValueError, match="int64"):
        tt.inter_counts(pad, idx, idx[:1])
    with pytest.raises(ValueError, match="device"):
        tt.inter_counts(pad.to("meta"), idx.to("meta"), idx.to("meta"))
    for bad in (-1, 3):
        with pytest.raises(ValueError, match="outside"):
            tt.inter_counts(pad, idx, torch.tensor([0, bad]))
        with pytest.raises(ValueError, match="outside"):  # the host checks on the CPU
            tt.inter_counts(pad, idx, torch.tensor([0, bad]), checked=True)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.mash_distances(_sketches(0, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.build_ltr_trees([], {}, "x")


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n,sizes,width", [
    (1, (5, 5), None), (2, (1, 1), None), (63, (1, 40), None), (65, (100, 255), None),
    (300, (256, 256), None), (40, (1, 1), 1), (50, (1, 37), 37), (12, (900, 1536), 1536)])
def test_cuda_inter_counts_matches_plain(n, sizes, width):
    """Widths of the path (256), 1, not a multiple of 32 and the kernel's
    1536, rows of every real size and an all-padding row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if width is None:
        pad = torch.from_numpy(_padded(_sketches(n, max(n, 2), sizes))).cuda()
    else:  # sketches wider than the pool: values drawn from the hash space
        rng = np.random.default_rng(n)
        pool = np.unique(rng.integers(0, 2**31 - 1, size=3 * width)).astype(np.int32)
        pad = np.full((n, width), BIG, np.int32)
        for i in range(n):
            v = np.sort(rng.choice(pool, size=int(rng.integers(sizes[0], sizes[1] + 1)),
                                   replace=False))
            pad[i, :v.size] = v
        pad = torch.from_numpy(pad).cuda()
    if pad.shape[0] > 2:
        pad[1] = BIG  # an empty sketch
    ai, bi = (torch.from_numpy(x).cuda() for x in np.triu_indices(pad.shape[0], 1))
    before = tt.launches["inter_counts"]
    got = tt.inter_counts(pad, ai, bi)
    want = tt.inter_counts_plain(pad, ai, bi)
    torch.cuda.synchronize()
    assert tt.launches["inter_counts"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(tt.inter_counts(pad, ai, bi, checked=True), want)


@pytest.mark.cuda
def test_cuda_inter_counts_one_kernel_a_call():
    """A call captured into a CUDA graph holds one kernel launch; indices
    outside [0, n) on the card still raise ValueError."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from subphaser_torch import kernels

    pad = torch.from_numpy(_padded(_sketches(7, 100))).cuda()
    ai, bi = (torch.from_numpy(x).cuda() for x in np.triu_indices(pad.shape[0], 1))
    assert kernels.graph_kernel_launches(
        lambda: tt.inter_counts(pad, ai, bi, checked=True)) == 1
    with pytest.raises(ValueError, match="outside"):
        tt.inter_counts(pad, ai, bi + 1)


@pytest.mark.cuda
def test_cuda_mash_distances_equal_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sk = _sketches(5, 200)
    assert np.array_equal(tt.mash_distances(sk, device="cuda"),
                          tt.mash_distances(sk, device="cpu"))
