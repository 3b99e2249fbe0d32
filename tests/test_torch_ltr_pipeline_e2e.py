"""PyTorch port, whole slice: the LTR step (its trees included) and custom
features through both Pipelines (the port on the CPU), on
tests/make_synthetic.make_genome(n_sets=2, chrom_size=120_000,
with_ltr_domains=True) with its profile database.

Tolerance: exact bytes for the seven LTR files (LTR.scn,
LTR.inner.fa.cls.tsv, LTR.filtered.LTR.fa, .ltr.bin.count, .ltr.enrich,
.ltr.insert.data, .ltr.insert.summary), the Copia tree's four files (.aln,
.trimal, .tree.nwk, .tree.map: the alignment route), the sketch route's
tree files, and the two custom-feature files (.custom.bin.count,
.custom.enrich).
"""

import logging
import os
import shutil

import pytest

from make_synthetic import make_genome
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

PREFIX = "k15_q50_f2"
OUT_FILES = [".ltr.bin.count", ".ltr.enrich", ".ltr.insert.data", ".ltr.insert.summary",
             ".custom.bin.count", ".custom.enrich"]
LTR_FILES = ["LTR.scn", "LTR.inner.fa.cls.tsv", "LTR.filtered.LTR.fa"]
TREE_FILES = [".Copia.aln", ".Copia.trimal", ".Copia.tree.nwk", ".Copia.tree.map"]


def _kw(hmm_db):
    return dict(min_freq=50, replicates=50, tile_bases=1 << 16, figfmt="png",
                disable_circos=True, disable_blocks=True, window_size=50_000,
                hmm_db=hmm_db)


def _features(genome: str, path: str) -> None:
    """Custom features: 5 kb windows every 20 kb of every chromosome."""
    from subphaser_torch.io.fasta import iter_fasta

    with open(path, "w") as f:
        for rid, _d, seq in iter_fasta(genome):
            s = seq.tobytes().decode()
            for j in range(0, len(s) - 5000, 20000):
                f.write(f">{rid}:{j}-{j + 5000}\n{s[j:j + 5000]}\n")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from subphaser_torch.phase.pipeline import Pipeline as TP
    from subphaser_tpu.phase.pipeline import Pipeline as JP

    base = tmp_path_factory.mktemp("torch_ltr_e2e")
    genome, cfg, hmm_db = make_genome(str(base), n_sets=2, chrom_size=120_000,
                                      with_ltr_domains=True)
    feats = str(base / "features.fa")
    _features(genome, feats)
    kw = dict(_kw(hmm_db), custom_features=[feats])
    JP([genome], [cfg], outdir=str(base / "jout"), tmpdir=str(base / "jtmp"), **kw).run()
    tpipe = TP([genome], [cfg], outdir=str(base / "tout"), tmpdir=str(base / "ttmp"),
               device="cpu", **kw).run()
    return base, genome, cfg, hmm_db, feats, tpipe


def _same(base, out, tmp):
    for suffix in OUT_FILES + TREE_FILES:
        want = (base / "jout" / (PREFIX + suffix)).read_bytes()
        assert (base / out / (PREFIX + suffix)).read_bytes() == want, suffix
    for name in LTR_FILES:
        want = (base / "jtmp" / "LTR" / name).read_bytes()
        assert (base / tmp / "LTR" / name).read_bytes() == want, name


def test_ltr_and_custom_files_identical(runs):
    base, _g, _c, _h, _f, tpipe = runs
    _same(base, "tout", "ttmp")
    lp = tpipe.ltr_pipeline
    assert lp.n_candidates > 10 and 0 < lp.n_ltr_order < lp.n_candidates
    assert tpipe.enriched_ltrs
    assert {"ltr_detect", "ltr_classify_pass1", "ltr_classify_pass2", "ltr_map",
            "ltr_enrich", "ltr_age", "ltr_tree", "custom_map", "custom_enrich"} \
        <= set(tpipe.step_seconds)
    leaves = (base / "tout" / (PREFIX + ".Copia.tree.map")).read_text().splitlines()
    assert len(leaves) >= 8


def test_resume_from_jax_tmpdir(runs, caplog):
    """The port resumes the LTR step from a JAX tmpdir: detection from
    LTR.scn, classification from the JAX-pickled .cls.pkl."""
    from subphaser_torch.phase.pipeline import Pipeline as TP

    base, genome, cfg, hmm_db, feats, _ = runs
    tmp = base / "rtmp"
    shutil.copytree(base / "jtmp", tmp)
    os.remove(tmp / "LTR" / "LTR.inner.fa.cls.tsv")  # only a fresh pass writes it
    with caplog.at_level(logging.INFO, logger="subphaser_torch"):
        TP([genome], [cfg], outdir=str(base / "rout"), tmpdir=str(tmp), device="cpu",
           custom_features=[feats], **_kw(hmm_db)).run()
    msgs = [r.message for r in caplog.records]
    assert any("LTR candidates from checkpoint" in m for m in msgs)
    assert any("Loaded classification checkpoint" in m for m in msgs)
    assert not (tmp / "LTR" / "LTR.inner.fa.cls.tsv").exists()
    for suffix in OUT_FILES + TREE_FILES:
        assert (base / "rout" / (PREFIX + suffix)).read_bytes() == \
            (base / "jout" / (PREFIX + suffix)).read_bytes(), suffix


def test_cli_runs_the_ltr_step(runs):
    """The CLI with the flags a user gives: -hmm_db, -disable_circos,
    -disable_blocks, -device cpu (the core steps resume from the port's own
    checkpoints); the LTR step runs with its trees."""
    from subphaser_torch import cli

    base, genome, cfg, hmm_db, feats, _ = runs
    pipe = cli.main(["-i", genome, "-c", cfg, "-o", str(base / "cout"),
                     "-tmpdir", str(base / "ttmp"), "-q", "50", "-replicates", "50",
                     "-tile_bases", str(1 << 16), "-window_size", "50000",
                     "-hmm_db", hmm_db, "-custom_features", feats, "-figfmt", "png",
                     "-disable_circos", "-disable_blocks", "-device", "cpu"])
    assert pipe.device.type == "cpu" and pipe.max_evalue == 1e-3
    assert not pipe.disable_ltrtree
    for suffix in OUT_FILES + TREE_FILES:
        assert (base / "cout" / (PREFIX + suffix)).read_bytes() == \
            (base / "jout" / (PREFIX + suffix)).read_bytes(), suffix


def test_all_ltr_fallback_without_hmm_db(runs, tmp_path):
    """No -hmm_db: classification is skipped and every detected LTR is kept
    (-all_ltr behaviour), as in the JAX package; the trees take the sketch
    route, one group "LTR"."""
    from subphaser_torch.phase.pipeline import Pipeline as TP
    from subphaser_tpu.phase.pipeline import Pipeline as JP

    base, genome, cfg, _h, _f, _ = runs
    kw = _kw(None)
    for name, cls, extra in (("j", JP, {}), ("t", TP, {"device": "cpu"})):
        tmp = tmp_path / f"{name}tmp"
        shutil.copytree(base / "jtmp", tmp, ignore=shutil.ignore_patterns("LTR"))
        cls([genome], [cfg], outdir=str(tmp_path / f"{name}out"), tmpdir=str(tmp),
            **kw, **extra).run()
    for suffix in (".ltr.bin.count", ".ltr.enrich", ".LTR.tree.nwk", ".LTR.tree.map"):
        assert (tmp_path / "tout" / (PREFIX + suffix)).read_bytes() == \
            (tmp_path / "jout" / (PREFIX + suffix)).read_bytes(), suffix
    assert not (tmp_path / "tout" / (PREFIX + ".LTR.aln")).exists()
    assert (tmp_path / "ttmp" / "LTR" / "LTR.filtered.LTR.fa").read_bytes() == \
        (tmp_path / "jtmp" / "LTR" / "LTR.filtered.LTR.fa").read_bytes()
    assert not (tmp_path / "ttmp" / "LTR" / "LTR.inner.fa.cls.tsv").exists()


def test_sketch_route_trees_identical(runs, tmp_path):
    """The sketch route (no domain peptides) of both packages'
    build_ltr_trees on the port run's enriched LTRs, each package given
    records of its own type with the same fields, and the same sequences."""
    import dataclasses

    from subphaser_torch.ltr.tree import build_ltr_trees as t_build
    from subphaser_tpu.ltr.records import LTRRecord as JRecord
    from subphaser_tpu.ltr.tree import build_ltr_trees as j_build

    *_, tpipe = runs
    ltrs = tpipe.enriched_ltrs
    j_ltrs = [JRecord(**dataclasses.asdict(ltr)) for ltr in ltrs]
    d_seqs = tpipe.ltr_pipeline.d_seqs
    kw = dict(d_colors={}, figfmt="png", d_class=None)
    out = t_build(ltrs, d_seqs, str(tmp_path / "t"), device="cpu", **kw)
    assert out == {k: tuple(p.replace(str(tmp_path / "j"), str(tmp_path / "t")) for p in v)
                   for k, v in j_build(j_ltrs, d_seqs, str(tmp_path / "j"), **kw).items()}
    assert "Copia" in out and not (tmp_path / "t.Copia.aln").exists()
    for suffix in (".Copia.tree.nwk", ".Copia.tree.map"):
        assert (tmp_path / ("t" + suffix)).read_bytes() == (tmp_path / ("j" + suffix)).read_bytes()
