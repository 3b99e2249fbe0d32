"""PyTorch port of ops/pca, PhaseCluster.pca, viz/plots and the pipeline's
core figures, against the JAX package's, on numpy-seeded inputs (the port
on the CPU).

Tolerance: PCA scores at rtol 1e-4 / atol 1e-5 and the explained-variance
ratio at 1e-5 (float32 gram matrices and two LAPACK eigensolvers; the data
have distinct eigenvalues, so each score column is fixed up to the sign
convention, which both packages apply). The histogram and heatmap PNGs of a
``-just_core -figfmt png`` run are byte-identical to the JAX CLI's: their
inputs are the same float64 arrays and matplotlib writes no date into a PNG.
"""

import logging
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from subphaser_torch.ops.pca import pca_fit_transform
from make_synthetic import make_genome
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PREFIX = "k15_q50_f2"
CORE = [".kmer.mat", ".chrom-subgenome.tsv", ".sig.kmer-subgenome.tsv",
        ".subgenome.bin.count", ".bin.enrich", ".bin.group"]
FIGURES = [".kmer_freq.png", ".kmer.mat.png", ".kmer_pca.png"]


def _planted(n: int, f: int, seed: int) -> np.ndarray:
    """(n, f) float32 data whose centred gram matrix has well separated
    eigenvalues: n directions of variance ~2.25^-i plus small noise (a
    range float32 resolves to the stated tolerance in every column)."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(f, n)))[0].T  # (n, f) orthonormal rows
    coef = rng.normal(size=(n, n)) * (1.5 ** -np.arange(n))[None, :] * np.sqrt(f)
    x = coef @ basis + 0.01 * rng.normal(size=(n, f))
    return x.astype(np.float32)


@pytest.mark.parametrize("n,f,k", [(4, 50, 2), (6, 300, 3), (9, 1000, 3), (20, 2000, 5)])
def test_pca_fit_transform_matches_jax(n, f, k):
    from subphaser_tpu.ops.pca import pca_fit_transform as jpca

    x = _planted(n, f, seed=n)
    scores, ratio = pca_fit_transform(torch.from_numpy(x), k)
    js, jr = jpca(x, k)
    assert scores.shape == (n, k) and ratio.shape == (k,)
    np.testing.assert_allclose(scores.numpy(), np.asarray(js), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ratio.numpy(), np.asarray(jr), atol=1e-5)
    # the sign convention: each column's largest-|value| entry is positive
    s = scores.numpy()
    assert np.all(s[np.abs(s).argmax(axis=0), np.arange(k)] > 0)


def test_pca_sign_of_zero_column_is_plus():
    """Identical samples: every score is 0, each column's sign 0 counts as
    +1 (no NaN), and the ratio is 0 (the total is clamped at 1e-30)."""
    from subphaser_tpu.ops.pca import pca_fit_transform as jpca

    x = np.tile(np.arange(-3, 5, dtype=np.float32), (5, 1))  # centred: exactly 0
    scores, ratio = pca_fit_transform(torch.from_numpy(x), 3)
    js, jr = jpca(x, 3)
    np.testing.assert_array_equal(scores.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ratio.numpy(), np.asarray(jr))
    assert not scores.isnan().any() and float(scores.abs().max()) == 0.0
    assert float(ratio.abs().max()) == 0.0


def _matrix(pkg: str, n_chrom: int = 6, n_kmers: int = 400, seed: int = 3):
    """A KmerMatrix of three planted subgenomes, in package ``pkg``."""
    import importlib

    spectrum = importlib.import_module(f"{pkg}.phase.spectrum")
    rng = np.random.default_rng(seed)
    sg = np.arange(n_chrom) % 3
    kmer_sg = rng.integers(0, 3, size=n_kmers)
    counts = rng.poisson(5, size=(n_kmers, n_chrom)) + \
        40 * (kmer_sg[:, None] == sg[None, :]) * rng.integers(1, 4, size=(n_kmers, 1))
    return spectrum.KmerMatrix(
        codes=np.arange(n_kmers, dtype=np.int32) * 7,
        counts=counts.astype(np.int32),
        tot=counts.sum(axis=1).astype(np.int64),
        lengths=np.full(n_chrom, 100_000, dtype=np.int64),
        labels=[f"{'ABD'[i % 3]}{i // 3 + 1}" for i in range(n_chrom)],
    )


@pytest.mark.parametrize("n_components", [2, 3, 10])
def test_phase_cluster_pca_matches_jax(n_components):
    from subphaser_torch.phase.cluster import PhaseCluster as TC
    from subphaser_tpu.phase.cluster import PhaseCluster as JC

    tc = TC(_matrix("subphaser_torch"), n_clusters=3, do_bootstrap=False, device="cpu")
    jc = JC(_matrix("subphaser_tpu"), n_clusters=3, do_bootstrap=False)
    ts, tr = tc.pca(n_components)
    js, jr = jc.pca(n_components)
    assert isinstance(ts, np.ndarray) and ts.shape == js.shape == (6, min(n_components, 6))
    # three subgenomes: the columns past the third are noise of near-equal
    # eigenvalues, each z-scored to unit variance, so only their shape,
    # the sign rule and the ratio are compared
    np.testing.assert_allclose(ts[:, :3], js[:, :3], rtol=1e-4, atol=1e-4)
    s = ts[:, 3:]
    assert np.all(s[np.abs(s).argmax(axis=0), np.arange(s.shape[1])] >= 0)
    np.testing.assert_allclose(tr, jr, atol=1e-5)


@pytest.fixture(scope="module")
def core_runs(tmp_path_factory):
    """tests/test_pipeline_e2e.py's fixture through both CLIs with
    -just_core -figfmt png."""
    from subphaser_torch import cli as tcli
    from subphaser_tpu import cli as jcli

    base = tmp_path_factory.mktemp("torch_figs")
    genome, cfg = make_genome(str(base), n_sets=3, chrom_size=100_000)
    args = ["-i", genome, "-c", cfg, "-q", "50", "-replicates", "50",
            "-tile_bases", str(1 << 16), "-just_core", "-figfmt", "png"]
    jcli.main([*args, "-o", str(base / "jout"), "-tmpdir", str(base / "jtmp")])
    tpipe = tcli.main([*args, "-o", str(base / "tout"), "-tmpdir", str(base / "ttmp"),
                       "-device", "cpu"])
    return base, genome, cfg, tpipe


def test_cli_writes_the_core_figures(core_runs):
    base, _g, _c, tpipe = core_runs
    for suffix in FIGURES:
        path = base / "tout" / (PREFIX + suffix)
        assert path.stat().st_size > 1000, suffix
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert set(tpipe.step_seconds) == {"pack", "count", "filter", "cluster"}


@pytest.mark.parametrize("suffix", [".kmer_freq.png", ".kmer.mat.png"])
def test_histogram_and_heatmap_identical_to_jax(core_runs, suffix):
    base = core_runs[0]
    assert (base / "tout" / (PREFIX + suffix)).read_bytes() == \
        (base / "jout" / (PREFIX + suffix)).read_bytes()


def test_pipeline_pca_matches_jax(core_runs):
    """The PCA behind .kmer_pca.png: the port's function on its cluster's
    z-scored matrix against the JAX function on the same matrix, and the
    leading column of PhaseCluster.pca after z-scoring. Two subgenomes:
    the leading column is held at rtol 1e-4 / atol 1e-5; the second is
    noise of the size of the float32 eigensolvers' error, eps x |gram| /
    gap, so every column is held at 1e-5 of the largest score."""
    from subphaser_tpu.ops import kmeans as jk
    from subphaser_tpu.ops.pca import pca_fit_transform as jpca

    tpipe = core_runs[3]
    cluster = tpipe.cluster
    n = max(2, tpipe.nsg)
    raw, ratio = pca_fit_transform(cluster._data, n)
    js, jr = jpca(cluster.data, n)
    js = np.asarray(js)
    np.testing.assert_allclose(raw.numpy()[:, 0], js[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(raw.numpy(), js, rtol=0, atol=1e-5 * np.abs(js).max())
    np.testing.assert_allclose(ratio.numpy(), np.asarray(jr), atol=1e-5)
    scores, ratio2 = cluster.pca(n)
    np.testing.assert_array_equal(ratio2, ratio.numpy())
    np.testing.assert_allclose(scores[:, 0], np.asarray(jk.zscore(js, axis=0))[:, 0],
                               rtol=1e-4, atol=1e-4)


def test_run_without_matplotlib_writes_core_files(core_runs, tmp_path, monkeypatch, caplog):
    """Where matplotlib does not import (as on a GPU host without it), the run
    writes the six core files, no figure, and logs the skip once."""
    from subphaser_torch.phase.pipeline import Pipeline

    _base, genome, cfg, _ = core_runs
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.INFO, logger="subphaser_torch"):
        pipe = Pipeline([genome], [cfg], outdir=str(tmp_path / "out"),
                        tmpdir=str(tmp_path / "tmp"), min_freq=50, replicates=50,
                        tile_bases=1 << 16, figfmt="png", disable_ltr=True,
                        disable_circos=True, window_size=50_000, device="cpu").run()
    for suffix in CORE:
        assert os.path.getsize(pipe.para_prefix + suffix) > 0, suffix
    assert not list((tmp_path / "out").glob("*.png"))
    skips = [r.message for r in caplog.records if "matplotlib is not installed" in r.message]
    assert len(skips) == 1 and "core figures" in skips[0]
    assert not any("failed" in r.message for r in caplog.records)


def test_plots_and_pipeline_import_without_matplotlib():
    code = ("import sys\nsys.modules['matplotlib'] = None\n"
            "import subphaser_torch.viz.plots, subphaser_torch.ops.pca\n"
            "import subphaser_torch.phase.pipeline\nprint('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_drawing_failure_is_logged_not_raised(core_runs, tmp_path, monkeypatch, caplog):
    """A failure inside matplotlib is a warning; the run goes on."""
    from subphaser_torch.viz import plots

    def broken(*_a, **_k):
        raise RuntimeError("no canvas")

    monkeypatch.setattr(plots, "plot_heatmap", broken)
    monkeypatch.setattr(plots, "plot_histogram", broken)
    from subphaser_torch import cli

    _base, genome, cfg, _ = core_runs
    with caplog.at_level(logging.WARNING, logger="subphaser_torch"):
        cli.main(["-i", genome, "-c", cfg, "-q", "50", "-replicates", "50",
                  "-tile_bases", str(1 << 16), "-just_core", "-figfmt", "png",
                  "-o", str(tmp_path / "out"), "-tmpdir", str(core_runs[0] / "ttmp"),
                  "-device", "cpu"])
    msgs = [r.message for r in caplog.records]
    assert any("Histogram plot failed: no canvas" in m for m in msgs)
    assert any("Core figures failed: no canvas" in m for m in msgs)
    assert (tmp_path / "out" / (PREFIX + ".sig.kmer-subgenome.tsv")).exists()
