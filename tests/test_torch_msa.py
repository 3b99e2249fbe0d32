"""PyTorch port: ltr/msa (progressive MSA, trimming, all-pairs match counts,
Kimura distances, NJ with bootstrap supports) against the JAX package's,
on the same seeded numpy inputs; the port on the CPU, where
``match_counts`` takes its plain version.

Tolerance: exact everywhere. The host parts are the same numpy code; the
counts are float32 sums of integer weights below 2^24, exact in any order;
the distances are compared as float64 arrays and the trees as strings.
The float route's tolerance on the card, with fractional weights:
2 L 2^-24 sum(w), twice the worst-case error of a float32 sum of L
non-negative terms, as its float32 adds and the matmuls' products sum the
same terms in other orders. Tests marked ``cuda`` hold
the kernel (csrc/tree_counts.cu) to its plain version on the card and skip
without one; they import nothing of the JAX package (the card's machine has
no JAX).
"""

import numpy as np
import pytest
import torch

from subphaser_torch.ltr import msa as tm
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

AA = tm.AA
GAP = tm.GAP


def _peptides(seed: int = 7, n: int = 12) -> list[str]:
    """``n`` peptides of 60-120 residues from one ancestor of 120, each with
    substitutions, a deletion and an insertion; one carries unknown
    residues (X, B), which encode_peptides drops."""
    rng = np.random.default_rng(seed)
    base = list(rng.choice(list(AA), 120))
    out = []
    for i in range(n):
        s = base[: int(rng.integers(67, 112))]  # 61..119 after the indels
        for p in rng.choice(len(s), 6, replace=False):
            s[p] = AA[rng.integers(0, 20)]
        d = int(rng.integers(0, len(s) - 8))
        del s[d : d + int(rng.integers(1, 8))]
        at = int(rng.integers(0, len(s)))
        s[at:at] = list(rng.choice(list(AA), int(rng.integers(1, 10))))
        if i == 3:
            s[5:5] = ["X", "B"]
        out.append("".join(s))
    return out


@pytest.fixture(scope="module")
def jm():
    from subphaser_tpu.ltr import msa

    return msa


@pytest.fixture(scope="module")
def aln():
    a = tm.progressive_msa(_peptides())
    assert a.shape[0] == 12 and (a == GAP).any()
    return a


def test_encode_peptides_exact(jm):
    peps = _peptides() + ["", "xyz", "acdXef"]
    got, want = tm.encode_peptides(peps), jm.encode_peptides(peps)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.uint8 and np.array_equal(g, w)


def test_guide_order_exact(jm):
    seqs = jm.encode_peptides(_peptides())
    assert tm._guide_order(seqs) == jm._guide_order(seqs)


@pytest.mark.parametrize("peps", ["twelve", "one", "none", "with_empty"])
def test_progressive_msa_exact(jm, peps):
    peps = {"twelve": _peptides(), "one": _peptides()[:1], "none": [],
            "with_empty": _peptides(3, 5) + ["XX"]}[peps]
    got, want = tm.progressive_msa(peps), jm.progressive_msa(peps)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("frac", [0.1, 0.5, 1.0])
def test_trim_alignment_exact(jm, aln, frac):
    (got, kept), (want, wkept) = tm.trim_alignment(aln, frac), jm.trim_alignment(aln, frac)
    assert np.array_equal(got, want) and np.array_equal(kept, wkept)


def _case(aln, name):
    if name == "peptides":
        return aln
    if name == "gaps":  # an all-gap row and an all-gap column
        a = aln.copy()
        a[3, :] = GAP
        a[:, 5] = GAP
        return a
    return aln[:1]  # n = 1


def _weights(length, name, seed=2):
    if name == "ones":
        return np.ones(length, np.float32)
    rng = np.random.default_rng(seed)
    return rng.multinomial(length, np.full(length, 1.0 / length)).astype(np.float32)


@pytest.mark.parametrize("weights", ["ones", "multinomial"])
@pytest.mark.parametrize("case", ["peptides", "gaps", "n1"])
def test_match_counts_plain_matches_jax(jm, aln, case, weights):
    import jax.numpy as jnp

    a = _case(aln, case)
    w = _weights(a.shape[1], weights)
    jv, jmat = (np.asarray(x) for x in jm._match_counts(jnp.asarray(a), jnp.asarray(w)))
    before = dict(tm.launches)
    v, m = tm.match_counts(torch.from_numpy(a), torch.from_numpy(w))
    assert tm.launches == before  # the CPU takes the plain version
    assert v.dtype == m.dtype == torch.float32
    assert np.array_equal(v.numpy(), jv) and np.array_equal(m.numpy(), jmat)


@pytest.mark.parametrize("case", ["peptides", "gaps"])
def test_expansion_identity_matches_jax(jm, aln, case):
    """The bits route's identity: the plain counts of the alignment's
    columns expanded by integer weights, with unit weights, equal the JAX
    package's weighted counts, for multinomial (bootstrap) weights."""
    import jax.numpy as jnp

    a = _case(aln, case)
    w = _weights(a.shape[1], "multinomial", seed=5)
    assert (w == 0).any() and (w > 1).any()
    idx = tm.expansion_index(w)
    assert idx.dtype == np.int32 and idx.size == int(w.sum())
    assert np.array_equal(np.bincount(idx, minlength=w.size), w)
    jv, jmat = (np.asarray(x) for x in jm._match_counts(jnp.asarray(a), jnp.asarray(w)))
    ex = torch.from_numpy(np.ascontiguousarray(a[:, idx]))
    v, m = tm.match_counts_plain(ex, torch.ones(idx.size))
    assert np.array_equal(v.numpy(), jv) and np.array_equal(m.numpy(), jmat)


@pytest.mark.parametrize("w,route", [
    (np.ones(5), "bits"),
    (np.array([0, 3, 0, 7, 1]), "bits"),           # zeros and counts above 1
    (np.zeros(4), "bits"),                          # no column at all
    (np.array([1.0, -1.0, 2.0]), "float"),          # a negative weight
    (np.array([1.0, 0.5, 2.0]), "float"),           # a fraction
    (np.array([1.0, np.nan]), "float"),
    (np.array([1.0, np.inf]), "float"),
    (np.array([tm.EXPANDED_LIMIT - 1, 0.0]), "bits"),  # the largest sum it takes
    (np.array([tm.EXPANDED_LIMIT - 1, 1.0]), "float"),  # a sum at the limit
    (np.full(3, float(1 << 24)), "float"),
])
def test_match_counts_route(w, route):
    assert tm.match_counts_route(np.asarray(w, np.float32)) == route


def test_match_counts_routes_on_the_trees_path():
    """Every weight set of nj_with_support's draw takes the bits route."""
    L = 628
    rng = np.random.default_rng(0)
    sets = rng.multinomial(L, np.full(L, 1.0 / L), size=100).astype(np.float32)
    assert tm.match_counts_route(np.ones(L, np.float32)) == "bits"
    assert all(tm.match_counts_route(w) == "bits" for w in sets)


@pytest.mark.parametrize("weights", ["ones", "multinomial"])
def test_kimura_distances_exact(jm, aln, weights):
    w = None if weights == "ones" else _weights(aln.shape[1], weights)
    got = tm.kimura_distances(aln, w, device="cpu")
    want = jm.kimura_distances(aln, w)
    assert got.dtype == want.dtype == np.float64 and np.array_equal(got, want)


def test_nj_with_support_identical(jm, aln):
    names = [f"e{i}" for i in range(aln.shape[0])]
    want = jm.nj_with_support(aln, names, n_boot=20)
    assert tm.nj_with_support(aln, names, n_boot=20, device="cpu") == want
    assert tm.nj_with_support(aln, names, n_boot=20, threads=1, device="cpu") == want


def test_write_fasta_alignment_identical_bytes(jm, aln, tmp_path):
    names = [f"e{i}" for i in range(aln.shape[0])]
    tm.write_fasta_alignment(str(tmp_path / "t.aln"), names, aln)
    jm.write_fasta_alignment(str(tmp_path / "j.aln"), names, aln)
    assert (tmp_path / "t.aln").read_bytes() == (tmp_path / "j.aln").read_bytes()


def test_match_counts_refuses_bad_input():
    a = torch.zeros((3, 4), dtype=torch.uint8)
    w = torch.ones(4)
    with pytest.raises(ValueError, match="uint8"):
        tm.match_counts(a.long(), w)
    with pytest.raises(ValueError, match="weights"):
        tm.match_counts(a, torch.ones(5))
    with pytest.raises(ValueError, match="weights"):
        tm.match_counts(a, w.double())
    with pytest.raises(ValueError, match="device"):
        tm.match_counts(a.to("meta"), w.to("meta"))


def test_entry_points_default_to_cuda(monkeypatch, aln):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.kimura_distances(aln)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.nj_with_support(aln, [str(i) for i in range(aln.shape[0])])


# ---------------------------------------------------------------------------
# the cases of tests/test_msa.py, on the port
# ---------------------------------------------------------------------------
def _onehot_profile(seq: np.ndarray) -> np.ndarray:
    prof = np.zeros((seq.size, 21), dtype=np.float32)
    prof[np.arange(seq.size), seq] = 1.0
    return prof


def test_profile_align_identity():
    from subphaser_torch.ltr.native import profile_align

    s = tm.encode_peptides(["ACDEFGHIKLMNPQRST"])[0]
    p = _onehot_profile(s)
    ops = profile_align(p, p @ tm.blosum62_21().T)
    assert ops.shape[0] == 1
    assert ops[0, 0] == 0 and ops[0, 1] == s.size


def test_profile_align_single_deletion():
    from subphaser_torch.ltr.native import profile_align

    a = tm.encode_peptides(["ACDEFGHIKLMNPQRSTVWY" * 2])[0]
    b = np.concatenate([a[:10], a[13:]])
    ops = profile_align(_onehot_profile(a), _onehot_profile(b) @ tm.blosum62_21().T)
    assert ops[:, 0].tolist().count(1) == 1
    assert ops[ops[:, 0] == 1][0][1] == 3
    assert ops[ops[:, 0] == 0][:, 1].sum() == b.size


def test_progressive_msa_rows_in_input_order():
    base = "ACDEFGHIKLMNPQRSTVWY" * 3
    aln = tm.progressive_msa([base, base[:30] + base[33:], base])
    assert aln.shape[0] == 3
    assert np.array_equal(aln[0], aln[2])
    assert int((aln[1] == GAP).sum()) == 3


def test_trim_alignment_drops_gap_columns():
    aln = np.full((10, 6), GAP, dtype=np.uint8)
    aln[:, :3] = 1
    aln[0, 3] = 2
    trimmed, kept = tm.trim_alignment(aln, min_residue_frac=0.1)
    assert kept.tolist() == [0, 1, 2, 3]
    assert trimmed.shape == (10, 4)


def test_kimura_distance_values():
    a = tm.encode_peptides(["ACDEFGHIKL"])[0]
    b = a.copy()
    b[0] = (b[0] + 1) % 20  # one mismatch of 10 -> p = 0.1
    d = tm.kimura_distances(np.stack([a, b]), device="cpu")
    assert d[0, 0] == 0.0
    p = 0.1
    assert d[0, 1] == pytest.approx(-np.log(1 - p - 0.2 * p * p), rel=1e-5)


def test_bootstrap_support_high_for_clean_split():
    import re

    rng = np.random.default_rng(3)
    base_a = "".join(rng.choice(list(AA), 80))
    base_b = "".join(rng.choice(list(AA), 80))

    def mut(s, n):
        s = list(s)
        for p in rng.choice(len(s), n, replace=False):
            s[p] = AA[rng.integers(0, 20)]
        return "".join(s)

    peps = [mut(base_a, 2), mut(base_a, 2), mut(base_b, 2), mut(base_b, 2)]
    nwk = tm.nj_with_support(tm.progressive_msa(peps), ["a1", "a2", "b1", "b2"],
                             n_boot=40, seed=1, device="cpu")
    sup = [int(x) for x in re.findall(r"\)(\d+):", nwk)]
    assert sup and max(sup) >= 90, nwk


def test_write_fasta_alignment(tmp_path):
    aln = np.array([[0, 1, GAP], [0, GAP, 2]], dtype=np.uint8)
    path = tmp_path / "x.aln"
    tm.write_fasta_alignment(str(path), ["s1", "s2"], aln)
    assert path.read_text() == ">s1\nAC-\n>s2\nA-D\n"


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("n,length", [(1, 1), (63, 77), (65, 64), (200, 1000), (1000, 129)])
@pytest.mark.parametrize("weights", ["ones", "multinomial"])
def test_cuda_match_counts_matches_plain(n, length, weights):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(n * 7 + length)
    a = rng.integers(0, 21, size=(n, length)).astype(np.uint8)
    a[: n // 3, : length // 2] = GAP  # gap-rich rows
    if n > 5:
        a[5] = GAP
    a[rng.random((n, length)) < 0.02] = 77  # a byte above 20: a residue matching nothing
    w_h = _weights(length, weights)
    w = torch.from_numpy(w_h).cuda()
    ac = torch.from_numpy(a).cuda()
    pv, pm = tm.match_counts_plain(ac, w)
    # the bits route
    before = tm.launches["match_counts"]
    by_route = dict(tm.route_launches["match_counts"])
    v, m = tm.match_counts(ac, w)
    torch.cuda.synchronize()
    assert tm.launches["match_counts"] == before + 1
    assert tm.route_launches["match_counts"] == dict(by_route, bits=by_route["bits"] + 1)
    assert torch.equal(v, pv) and torch.equal(m, pm)
    # the float route, with fractional weights: within 2 L 2^-24 sum(w)
    wf = w * 0.7 + 0.1  # not multiples of a power of 2: the float32 sums round
    before = dict(tm.route_launches["match_counts"])
    v, m = tm.match_counts(ac, wf)
    fv, fm = tm.match_counts_plain(ac, wf)
    torch.cuda.synchronize()
    assert tm.route_launches["match_counts"] == dict(before, float=before["float"] + 1)
    tol = 2 * length * 2.0 ** -24 * float(wf.sum())
    assert float((v - fv).abs().max()) <= tol and float((m - fm).abs().max()) <= tol


@pytest.mark.cuda
def test_cuda_kimura_from_threads(aln):
    """nj_with_support's threads launch the kernel concurrently: the
    distances and the tree equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import sys

    names = [f"e{i}" for i in range(aln.shape[0])]
    before = tm.launches["match_counts"]
    bits = tm.route_launches["match_counts"]["bits"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = tm.nj_with_support(aln, names, n_boot=100, threads=16, device="cuda")
    finally:
        sys.setswitchinterval(interval)
    assert tm.launches["match_counts"] == before + 101  # no update lost
    assert tm.route_launches["match_counts"]["bits"] == bits + 101  # every call took bits
    assert got == tm.nj_with_support(aln, names, n_boot=100, device="cpu")
