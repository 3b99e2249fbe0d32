"""PyTorch port of the auxiliary host tools (utils/pool, viz/density,
phase/stat_enrich, io/split) held to tests/test_utils_aux.py's cases and to
the JAX package's modules on the same inputs.

Tolerance: exact. Return values are compared with ``==`` and every file
either writes is compared byte for byte.
"""

import io
import subprocess
import sys
import pathlib

import numpy as np
import pytest

from subphaser_torch.io.fasta import write_fasta
from subphaser_torch.utils.pool import ncpus, pool_map, run_tasks

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("workers,ordered", [(4, True), (1, True), (3, False)])
def test_pool_map(workers, ordered):
    from subphaser_tpu.utils.pool import pool_map as jpool_map

    items = list(range(20))
    got = pool_map(lambda x: x * 2, items, workers=workers, ordered=ordered)
    want = jpool_map(lambda x: x * 2, items, workers=workers, ordered=ordered)
    if ordered:
        assert got == want == [x * 2 for x in items]
    else:
        assert sorted(got) == sorted(want) == [x * 2 for x in items]
    assert ncpus() >= 1


def test_run_tasks_retries_flaky():
    calls = {}

    def flaky(x):
        calls[x] = calls.get(x, 0) + 1
        if x == 3 and calls[x] < 3:
            raise RuntimeError("transient")
        return x + 100

    out = run_tasks(flaky, list(range(5)), workers=2, retry=3, backoff=0)
    assert out == [100, 101, 102, 103, 104]
    assert calls == {0: 1, 1: 1, 2: 1, 3: 3, 4: 1}  # only the failed item re-runs


def test_run_tasks_raises_persistent():
    from subphaser_tpu.utils.pool import run_tasks as jrun_tasks

    msgs = []
    for fn in (run_tasks, jrun_tasks):
        with pytest.raises(RuntimeError, match="failed after") as e:
            fn(lambda x: 1 / 0, [1], retry=2, backoff=0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _density_inputs(tmp_path):
    gff = tmp_path / "a.gff3"
    gff.write_text(
        "##gff3\nc1\tsrc\tgene\t100\t500\t.\t+\t.\tID=g1\n"
        "c1\tsrc\tmRNA\t100\t500\t.\t+\t.\tID=m1\n"
        "c1\tsrc\tgene\t150000\t151000\t.\t+\t.\tID=g2\n"
        "c2\tsrc\tgene\t5\t50\t.\t-\t.\tID=g3\n"
    )
    vcf = tmp_path / "a.vcf"
    vcf.write_text(
        "##vcf\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "c1\t5\t.\tA\tT\t.\t.\t.\tGT\t0/1\n"
        "c1\t6\t.\tA\tT\t.\t.\t.\tGT\t1/1\n"
        "c1\t250\t.\tA\tT\t.\t.\t.\tGT\t0|1\n"
    )
    fa = tmp_path / "a.fa"
    fa.write_text(">c1\n" + "G" * 50 + "A" * 50 + "NNNNCCGT\n>c2\nacgtgc\n")
    bed = tmp_path / "a.bed"
    bed.write_text("#h\nc1\t10\t20\nc1\t150\t160\nc1\t95\t230\nc2\t7\n")
    rm = tmp_path / "a.out"
    rm.write_text(
        "   SW  perc perc perc  query      position in query\n\n"
        "  100  1.0  0.0  0.0  c1  11  130  (10) + Gypsy  LTR/Gypsy 1 120 (0) 1\n"
        "   90  2.0  0.0  0.0  c2  301  350  (10) + Copia  LTR/Copia 1 50 (0) 2\n"
    )
    return {"gene": gff, "variant": vcf, "gc": fa, "bed": bed, "repeat": rm}


@pytest.mark.parametrize("kind,kw", [
    ("gene", {}), ("variant", {}), ("variant", {"het_only": True}), ("gc", {}),
    ("bed", {}), ("bed", {"by_sites": True}), ("repeat", {}), ("repeat", {"by_sites": False}),
])
def test_density_tools_match_jax(tmp_path, kind, kw):
    from subphaser_torch.viz import density as td
    from subphaser_tpu.viz import density as jd

    path = str(_density_inputs(tmp_path)[kind])
    window = 100
    got = getattr(td, f"{kind}_density")(path, window_size=window, **kw)
    want = getattr(jd, f"{kind}_density")(path, window_size=window, **kw)
    assert got == want and list(got) == list(want)
    td.write_density(got, str(tmp_path / "t.txt"), window)
    jd.write_density(want, str(tmp_path / "j.txt"), window)
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_density_cases_of_the_jax_tests(tmp_path):
    """tests/test_utils_aux.py::test_density_tools's assertions."""
    from subphaser_torch.viz.density import (
        bed_density, gc_density, gene_density, variant_density, write_density,
    )

    gff = tmp_path / "a.gff3"
    gff.write_text(
        "##gff3\nc1\tsrc\tgene\t100\t500\t.\t+\t.\tID=g1\n"
        "c1\tsrc\tmRNA\t100\t500\t.\t+\t.\tID=m1\n"
        "c1\tsrc\tgene\t150000\t151000\t.\t+\t.\tID=g2\n"
    )
    assert gene_density(str(gff), window_size=100_000) == {"c1": {0: 1, 1: 1}}
    vcf = tmp_path / "a.vcf"
    vcf.write_text(
        "##vcf\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        "c1\t5\t.\tA\tT\t.\t.\t.\tGT\t0/1\n"
        "c1\t6\t.\tA\tT\t.\t.\t.\tGT\t1/1\n"
    )
    assert variant_density(str(vcf), window_size=100) == {"c1": {0: 2}}
    assert variant_density(str(vcf), window_size=100, het_only=True) == {"c1": {0: 1}}
    fa = tmp_path / "a.fa"
    fa.write_text(">c1\n" + "G" * 50 + "A" * 50 + "\n")
    assert gc_density(str(fa), window_size=100)["c1"][0] == 50.0
    bed = tmp_path / "a.bed"
    bed.write_text("c1\t10\t20\nc1\t150\t160\n")
    d = bed_density(str(bed), window_size=100)
    assert d == {"c1": {0: 1, 1: 1}}
    out = tmp_path / "dens.txt"
    write_density(d, str(out), 100)
    assert out.read_text() == "c1 0 100 1\nc1 100 200 1\n"


@pytest.mark.parametrize("kind", ["gene", "gc", "bed"])
def test_density_cli_matches_jax(tmp_path, kind):
    src = str(_density_inputs(tmp_path)[kind])
    outs = []
    for pkg in ("subphaser_torch", "subphaser_tpu"):
        out = tmp_path / f"{pkg}.txt"
        res = subprocess.run([sys.executable, "-m", f"{pkg}.viz.density", kind, src, str(out),
                              "100"], cwd=str(ROOT), capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0]


def test_density_cli_usage():
    from subphaser_torch.viz.density import main

    assert main([]) == 1


def _enrich_tsv(tmp_path):
    tsv = tmp_path / "x.enrich"
    tsv.write_text(
        "#id\tsubgenome\tp_value\tcounts\n"
        "Gypsy-1\tSG1\t0.01\t5,1\n"
        "Gypsy-2\tSG1\t0.02\t3,0\n"
        "Copia-1\tSG2\t0.01\t0,7\n"
        "short\tline\n"
        "Helitron\tSG2\t0.03\t2,2\n"
    )
    return tsv


def test_stat_enrich_matches_jax(tmp_path):
    from subphaser_torch.phase.stat_enrich import stat_enrich
    from subphaser_tpu.phase.stat_enrich import stat_enrich as jstat_enrich

    tsv = _enrich_tsv(tmp_path)
    got, want = io.StringIO(), io.StringIO()
    stat_enrich(str(tsv), got)
    jstat_enrich(str(tsv), want)
    assert got.getvalue() == want.getvalue()
    lines = got.getvalue().splitlines()
    assert lines[0] == "Copia\t0\t1\t0\t7"
    assert lines[1] == "Gypsy\t2\t0\t8\t1"


def test_stat_enrich_cli_matches_jax(tmp_path):
    tsv = _enrich_tsv(tmp_path)
    outs = []
    for pkg in ("subphaser_torch", "subphaser_tpu"):
        res = subprocess.run([sys.executable, "-m", f"{pkg}.phase.stat_enrich", str(tsv)],
                             cwd=str(ROOT), capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        outs.append(res.stdout)
    assert outs[0] == outs[1] and outs[0].startswith("Copia\t")


def test_cut_seqs_and_split(tmp_path):
    """tests/test_utils_aux.py::test_cut_seqs_and_split's cases, and the
    same windows, offsets, chunks and files as the JAX package."""
    from subphaser_torch.io.fasta import iter_fasta
    from subphaser_torch.io.split import balanced_chunks, cut_seqs, split_fasta_balanced
    from subphaser_tpu.io import split as jsplit

    write_fasta(str(tmp_path / "a.fa"), [("c1", "A" * 250), ("c2", "C" * 90)])
    out, jout = io.StringIO(), io.StringIO()
    offsets = cut_seqs(str(tmp_path / "a.fa"), out, window_size=100, window_ovl=20)
    assert offsets == jsplit.cut_seqs(str(tmp_path / "a.fa"), jout, window_size=100,
                                      window_ovl=20)
    assert out.getvalue() == jout.getvalue()
    assert offsets["c1:1-120"] == ("c1", 0)
    assert offsets["c1:101-220"] == ("c1", 100)
    assert offsets["c1:201-250"] == ("c1", 200)
    assert offsets["c2:1-90"] == ("c2", 0)

    sizes = {"a": 100, "b": 90, "c": 50, "d": 40}
    chunks = balanced_chunks(sizes, 2)
    assert chunks == jsplit.balanced_chunks(sizes, 2)
    assert sorted(sum(sizes[x] for x in ch) for ch in chunks) == [140, 140]
    assert balanced_chunks(sizes, 0) == jsplit.balanced_chunks(sizes, 0)

    files = split_fasta_balanced(str(tmp_path / "a.fa"), str(tmp_path / "s"), 2)
    jfiles = jsplit.split_fasta_balanced(str(tmp_path / "a.fa"), str(tmp_path / "j"), 2)
    assert len(files) == len(jfiles) == 2
    for f, jf in zip(files, jfiles):
        assert pathlib.Path(f).read_bytes() == pathlib.Path(jf).read_bytes()
    names = set()
    for f in files:
        names |= {rid for rid, _d, _s in iter_fasta(f)}
    assert names == {"c1", "c2"}


def test_cut_seqs_many_windows(tmp_path):
    from subphaser_torch.io.split import cut_seqs
    from subphaser_tpu.io.split import cut_seqs as jcut_seqs

    rng = np.random.default_rng(9)
    seqs = [(f"s{i}", "".join(rng.choice(list("ACGTN"), size=n)))
            for i, n in enumerate((1, 99, 100, 101, 1234))]
    write_fasta(str(tmp_path / "b.fa"), seqs)
    out, jout = io.StringIO(), io.StringIO()
    got = cut_seqs([str(tmp_path / "b.fa")], out, window_size=100, window_ovl=30)
    want = jcut_seqs([str(tmp_path / "b.fa")], jout, window_size=100, window_ovl=30)
    assert got == want and out.getvalue() == jout.getvalue()
