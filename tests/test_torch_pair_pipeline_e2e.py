"""PyTorch port, the pair-code path as a whole: the k = 17 fixture of
tests/test_pair_pipeline.py through both Pipelines (the port on the CPU).

Tolerance: exact bytes for .kmer.mat, .sig.kmer-subgenome.tsv,
.subgenome.bin.count, .bin.enrich and .bin.group; identical assignment
columns in .chrom-subgenome.tsv (the support column comes from each
package's own random draws).
"""

import logging

import pytest

from tests.make_synthetic import make_genome
from span_paths import assert_children_within_parents, steps, sub_spans
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(k=17, min_freq=40, replicates=10, tile_bases=1 << 16, figfmt="png",
          disable_ltr=True, disable_circos=True, window_size=40_000)
PREFIX = "k17_q40_f2"
EXACT = [".kmer.mat", ".sig.kmer-subgenome.tsv", ".subgenome.bin.count",
         ".bin.enrich", ".bin.group"]
# the nested spans of the pair-code path: its own count passes (the fast
# path, one sort a chromosome) and lookups, no table
SUB_SPANS = {"pack/read", "pack/save", "count/key", "count/tiles", "count/stage",
             "count/codes", "count/sort", "count/runs", "count/compact", "count/collect",
             "count/save", "filter/select", "filter/write", "cluster/kmeans", "cluster/tests",
             "cluster/write", "map/search", "map/sort", "map/runs", "map/write"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from subphaser_torch.phase.pipeline import Pipeline as TP
    from subphaser_tpu.phase.pipeline import Pipeline as JP

    base = tmp_path_factory.mktemp("torch_pair_e2e")
    genome, cfg = make_genome(str(base), n_sets=2, chrom_size=80_000)
    JP([genome], [cfg], outdir=str(base / "jout"), tmpdir=str(base / "jtmp"), **KW).run()
    tpipe = TP([genome], [cfg], outdir=str(base / "tout"), tmpdir=str(base / "ttmp"),
               device="cpu", **KW).run()
    return base, genome, cfg, tpipe


def _assignments(path):
    rows = [line.split("\t") for line in path.read_text().splitlines()[1:]]
    return [r[:2] for r in rows]


def _same_outputs(base, out):
    for suffix in EXACT:
        ref = (base / "jout" / (PREFIX + suffix)).read_bytes()
        got = (base / out / (PREFIX + suffix)).read_bytes()
        assert got == ref and len(got) > 0, f"{suffix} differs"
    ja = _assignments(base / "jout" / (PREFIX + ".chrom-subgenome.tsv"))
    ta = _assignments(base / out / (PREFIX + ".chrom-subgenome.tsv"))
    assert ta == ja
    a = {sg for c, sg in ta if c.startswith("A")}
    b = {sg for c, sg in ta if c.startswith("B")}
    assert len(a) == 1 and len(b) == 1 and a != b


def test_core_files_identical(runs):
    base, _g, _c, tpipe = runs
    _same_outputs(base, "tout")
    assert tpipe.map_dense is False  # pair codes never take the dense table
    assert set(steps(tpipe.step_seconds)) == {"pack", "count", "filter", "cluster", "map",
                                              "enrich"}
    assert sub_spans(tpipe.step_seconds) == SUB_SPANS
    assert_children_within_parents(tpipe.step_seconds)
    sig = (base / "tout" / (PREFIX + ".sig.kmer-subgenome.tsv")).read_text().splitlines()
    kmer = sig[1].split("\t")[0]
    assert len(kmer) == 17 and set(kmer) <= set("ACGT")


def test_resume_from_jax_tmpdir(runs, caplog):
    """The port finishes a k = 17 run from the JAX package's packed genome
    and int64 count checkpoints (pair-code mapping has no checkpoints in
    either package) and writes the same files."""
    from subphaser_torch.phase.pipeline import Pipeline as TP

    base, genome, cfg, _ = runs
    with caplog.at_level(logging.INFO, logger="subphaser_torch"):
        TP([genome], [cfg], outdir=str(base / "rout"), tmpdir=str(base / "jtmp"),
           device="cpu", **KW).run()
    msgs = [r.message for r in caplog.records]
    assert any("Loaded packed genome checkpoint" in m for m in msgs)
    assert sum("Loaded spectrum checkpoint" in m for m in msgs) == 4
    _same_outputs(base, "rout")


def test_cli_k17(runs):
    from subphaser_torch import cli

    base, genome, cfg, _ = runs
    pipe = cli.main(["-i", genome, "-c", cfg, "-o", str(base / "cout"),
                     "-tmpdir", str(base / "ctmp"), "-k", "17", "-q", "40",
                     "-replicates", "10", "-tile_bases", str(1 << 16),
                     "-window_size", "40000", "-disable_ltr", "-disable_circos",
                     "-disable_blocks", "-device", "cpu"])
    assert pipe.device.type == "cpu" and pipe.k == 17
    _same_outputs(base, "cout")


@pytest.mark.parametrize("k", [0, 32])
def test_k_outside_1_to_31_raises(runs, k):
    from subphaser_torch.phase.pipeline import Pipeline as TP

    _base, genome, cfg, _ = runs
    with pytest.raises(ValueError, match="unsupported"):
        TP([genome], [cfg], device="cpu", **dict(KW, k=k))
