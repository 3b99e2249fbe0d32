"""PyTorch port, whole slice: the tests/test_pipeline_e2e.py fixture through
both Pipelines (the port on the CPU).

Tolerance: exact bytes for .kmer.mat, .sig.kmer-subgenome.tsv,
.subgenome.bin.count, .bin.enrich and .bin.group; identical assignment
columns in .chrom-subgenome.tsv, with bootstrap support >= 90 in both (the
support column comes from each package's own random draws).
"""

import logging

import pytest

from tests.make_synthetic import make_genome
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(min_freq=50, replicates=50, tile_bases=1 << 16, figfmt="png",
          disable_ltr=True, disable_circos=True, window_size=50_000)
PREFIX = "k15_q50_f2"
EXACT = [".kmer.mat", ".sig.kmer-subgenome.tsv", ".subgenome.bin.count",
         ".bin.enrich", ".bin.group"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from subphaser_torch.phase.pipeline import Pipeline as TP
    from subphaser_tpu.phase.pipeline import Pipeline as JP

    base = tmp_path_factory.mktemp("torch_e2e")
    genome, cfg = make_genome(str(base), n_sets=3, chrom_size=100_000)
    JP([genome], [cfg], outdir=str(base / "jout"), tmpdir=str(base / "jtmp"), **KW).run()
    tpipe = TP([genome], [cfg], outdir=str(base / "tout"), tmpdir=str(base / "ttmp"),
               device="cpu", **KW).run()
    return base, genome, cfg, tpipe


def _assignments(path):
    rows = [line.split("\t") for line in path.read_text().splitlines()[1:]]
    return [r[:2] for r in rows], [int(r[2]) for r in rows]


def _same_outputs(base, out):
    for suffix in EXACT:
        ref = (base / "jout" / (PREFIX + suffix)).read_bytes()
        got = (base / out / (PREFIX + suffix)).read_bytes()
        assert got == ref, f"{suffix} differs"
    ja, jsup = _assignments(base / "jout" / (PREFIX + ".chrom-subgenome.tsv"))
    ta, tsup = _assignments(base / out / (PREFIX + ".chrom-subgenome.tsv"))
    assert ta == ja
    assert min(jsup) >= 90 and min(tsup) >= 90


def test_core_files_identical(runs):
    base, _g, _c, tpipe = runs
    _same_outputs(base, "tout")
    assert tpipe.map_dense is False  # < 50 Mb: the searchsorted path
    assert set(tpipe.step_seconds) == {"pack", "count", "filter", "cluster", "map", "enrich"}


def test_resume_from_jax_tmpdir(runs, caplog):
    """The port resumes from the checkpoints the JAX run left behind."""
    from subphaser_torch.phase.pipeline import Pipeline as TP

    base, genome, cfg, _ = runs
    with caplog.at_level(logging.INFO, logger="subphaser_torch"):
        TP([genome], [cfg], outdir=str(base / "rout"), tmpdir=str(base / "jtmp"),
           device="cpu", **KW).run()
    msgs = [r.message for r in caplog.records]
    assert any("Loaded packed genome checkpoint" in m for m in msgs)
    assert sum("Loaded spectrum checkpoint" in m for m in msgs) == 6
    assert any("Resumed mapping from checkpoint for 6/6" in m for m in msgs)
    _same_outputs(base, "rout")


def test_cli_just_core(runs):
    from subphaser_torch import cli

    base, genome, cfg, _ = runs
    pipe = cli.main(["-i", genome, "-c", cfg, "-o", str(base / "cout"),
                     "-tmpdir", str(base / "ttmp"), "-q", "50", "-replicates", "50",
                     "-tile_bases", str(1 << 16), "-just_core", "-device", "cpu"])
    assert pipe.device.type == "cpu"
    for suffix in (".kmer.mat", ".sig.kmer-subgenome.tsv"):
        assert (base / "cout" / (PREFIX + suffix)).read_bytes() == \
            (base / "jout" / (PREFIX + suffix)).read_bytes()
    assert not (base / "cout" / (PREFIX + ".subgenome.bin.count")).exists()


@pytest.mark.parametrize("extra,item", [
    (dict(disable_circos=False), "A11"),
    (dict(custom_features=["f.fa"], disable_circos=False), "A11"),
    (dict(disable_ltr=False, disable_circos=False), "A11"),
    (dict(n_devices=2), "A12"),
    (dict(trace="trace_dir"), "A14"),
])
def test_unported_steps_refused(runs, extra, item):
    from subphaser_torch.phase.pipeline import Pipeline as TP

    _base, genome, cfg, _ = runs
    kw = dict(KW, **extra)
    with pytest.raises(NotImplementedError, match=item):
        TP([genome], [cfg], device="cpu", **kw)


def test_ltr_step_with_trees_accepted(runs):
    """The LTR step runs whole, its trees included (no -disable_ltrtree)."""
    from subphaser_torch.phase.pipeline import Pipeline as TP

    _base, genome, cfg, _ = runs
    pipe = TP([genome], [cfg], device="cpu", **dict(KW, disable_ltr=False))
    assert not pipe.disable_ltr and not pipe.disable_ltrtree
