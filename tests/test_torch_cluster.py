"""PyTorch port: k-means / bootstrap / PhaseCluster against the JAX package.

The two packages draw different random numbers (JAX PRNG vs
torch.Generator), so the port is held to identical canonical labels and an
identical sig.kmer-subgenome.tsv. Tolerances: z-scores 1e-6 relative
(float32, different reduction order); ARI / V-measure 1e-6 absolute on
identical label inputs (the port computes them in float64, the JAX package
in float32); labels and files exact.
"""

import io

import jax
import numpy as np
import pytest
import torch

from subphaser_torch.ops import kmeans as tk
from subphaser_tpu.ops import kmeans as jk
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def matrices(tmp_path_factory):
    """Differential k-mer matrix of a synthetic allotetraploid, as the JAX
    package builds it, and the port's copy of it."""
    from subphaser_torch.phase.spectrum import KmerMatrix as TM
    from subphaser_tpu.io.genome import PackedGenome
    from subphaser_tpu.ops.filter import make_group_spec
    from subphaser_tpu.phase.filtering import streaming_filter
    from subphaser_tpu.phase.spectrum import count_genome
    from tests.make_synthetic import make_genome

    base = tmp_path_factory.mktemp("cluster")
    fa, _ = make_genome(str(base), n_sets=3, chrom_size=60_000)
    g, _ = PackedGenome.from_fasta_files([fa], workers=1)
    spectra = count_genome(g, 15, lower_count=2, tile_bases=1 << 15)
    gi = [[[0], [1]], [[2], [3]], [[4], [5]]]
    res = streaming_filter(spectra, make_group_spec(gi, 6), min_freq=10,
                           max_freq=1e9, min_fold=2.0)
    jm = res.matrix
    tm = TM(codes=jm.codes, counts=jm.counts, tot=jm.tot, lengths=jm.lengths,
            labels=list(jm.labels))
    return jm, tm


def test_zscore_close():
    rng = np.random.default_rng(0)
    x = rng.random((6, 500)).astype(np.float32) * 1e-3
    x[:, 7] = 0.25  # zero-variance column
    ref = np.asarray(jk.zscore(x, axis=0))
    got = tk.zscore(torch.from_numpy(x), axis=0).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.all(got[:, 7] == 0)


def test_canonical_labels_identical():
    rng = np.random.default_rng(1)
    order = np.argsort(np.array(["c%02d" % i for i in rng.permutation(9)]))
    labels = rng.integers(0, 3, size=(40, 9))
    got = tk.canonical_labels(torch.from_numpy(labels), order, 3).numpy()
    for lab, g in zip(labels, got):
        ref = np.asarray(jk.canonical_labels(lab, order, 3))
        assert np.array_equal(g, ref)


def test_ari_vmeasure_close():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 3, size=(25, 12))
    b = rng.integers(0, 3, size=(25, 12))
    b[:5] = a[:5]  # some perfect agreements
    ari = tk.adjusted_rand_score(torch.from_numpy(a), torch.from_numpy(b), 3).numpy()
    vm = tk.v_measure_score(torch.from_numpy(a), torch.from_numpy(b), 3).numpy()
    for i in range(len(a)):
        assert abs(ari[i] - float(jk.adjusted_rand_score(a[i], b[i], 3))) <= 1e-6
        assert abs(vm[i] - float(jk.v_measure_score(a[i], b[i], 3))) <= 1e-6


def test_kmeans_fit_same_canonical_labels():
    rng = np.random.default_rng(3)
    centers = rng.normal(size=(3, 40)) * 5
    truth = np.array([0, 1, 2, 0, 1, 2, 0, 1])
    x = (centers[truth] + rng.normal(size=(8, 40))).astype(np.float32)
    order = np.argsort(np.array([f"c{i}" for i in range(8)]))
    jl, _ = jk.kmeans_fit(x, jax.random.PRNGKey(0), 3)
    gen = torch.Generator().manual_seed(0)
    tl, inertia = tk.kmeans_fit(torch.from_numpy(x), gen, 3)
    assert tl.shape == (8,) and inertia.shape == ()
    assert np.array_equal(tk.canonical_labels(tl, order, 3).numpy(),
                          np.asarray(jk.canonical_labels(jl, order, 3)))


def test_bootstrap_batched_support():
    rng = np.random.default_rng(4)
    truth = np.array([0, 1, 0, 1, 0, 1])
    x = (np.where(truth[:, None] == 0, 1.0, -1.0) * np.ones((6, 300))
         + rng.normal(size=(6, 300)) * 0.3).astype(np.float32)
    order = np.arange(6)
    gen = torch.Generator().manual_seed(1)
    support, ari, vm = tk.bootstrap(torch.from_numpy(x), truth, order, gen,
                                    n_clusters=2, replicates=30)
    assert support.dtype == torch.int32 and support.tolist() == [100] * 6
    assert abs(float(ari) - 1.0) <= 1e-6 and abs(float(vm) - 1.0) <= 1e-6


def test_phase_cluster_identical_labels_and_sig_file(matrices):
    from subphaser_torch.phase.cluster import PhaseCluster as TP
    from subphaser_tpu.phase.cluster import PhaseCluster as JP

    jm, tm = matrices
    jc = JP(jm, n_clusters=2, replicates=20, seed=0)
    tc = TP(tm, n_clusters=2, replicates=20, seed=0, device="cpu")
    assert np.array_equal(tc.labels, jc.labels)
    assert dict(tc.d_sg) == dict(jc.d_sg) and tc.sg_names == jc.sg_names
    np.testing.assert_allclose(tc.data, jc.data, rtol=1e-6, atol=1e-6)
    assert min(tc.d_bs.values()) >= 90 and min(jc.d_bs.values()) >= 90
    jf, tf = io.StringIO(), io.StringIO()
    jsig = jc.output_kmers(jf, 15)
    tsig = tc.output_kmers(tf, 15)
    assert tf.getvalue() == jf.getvalue()
    for name in ("codes", "sg", "canon_codes", "canon_sg"):
        assert np.array_equal(getattr(tsig, name), getattr(jsig, name))
    jsub, tsub = io.StringIO(), io.StringIO()
    jc.output_subgenomes(jsub)
    tc.output_subgenomes(tsub)
    strip = [line.split("\t")[:2] for line in tsub.getvalue().splitlines()]
    assert strip == [line.split("\t")[:2] for line in jsub.getvalue().splitlines()]


def test_matrix_file_identical(matrices, tmp_path):
    from subphaser_torch.phase.cluster import load_matrix_file, write_matrix_file as tw
    from subphaser_tpu.phase.cluster import write_matrix_file as jw

    jm, tm = matrices
    jf, tf = io.StringIO(), io.StringIO()
    jw(jm, 15, jf)
    tw(tm, 15, tf)
    assert tf.getvalue() == jf.getvalue()
    path = tmp_path / "m.kmer.mat"
    path.write_text(tf.getvalue())
    back = load_matrix_file(str(path), 15)
    assert np.array_equal(back.codes, tm.codes) and back.labels == tm.labels


def test_sg_assigned_skips_kmeans(matrices):
    from subphaser_torch.phase.cluster import PhaseCluster as TP
    from subphaser_tpu.phase.cluster import PhaseCluster as JP

    jm, tm = matrices
    assigned = {c: ("X" if c.startswith("CMA") else "Y") for c in tm.labels}
    jc = JP(jm, n_clusters=2, sg_assigned=assigned, replicates=10)
    tc = TP(tm, n_clusters=2, sg_assigned=assigned, replicates=10, device="cpu")
    assert dict(tc.d_sg) == dict(jc.d_sg)
