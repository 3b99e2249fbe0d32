"""PyTorch port: the Pipeline constructor's option checks and parsing against
the JAX package's, on the inputs of tests/test_flags.py's
``test_external_aligner_errors`` and ``test_compat_flags_warn``.

Both packages' ``Pipeline`` run on the same synthetic genome. The port
still refuses circos (ROADMAP A11), so the compat-flags case gives both
packages ``disable_circos`` (and ``disable_ltrtree``); neither changes what
the options parse into. Also: the LTR trees' defaults (``subsample``,
``ltr_domains``) without those kwargs, and the tree step's guard.
"""

import logging

import pytest

from make_synthetic import make_genome

PACKAGES = ["subphaser_tpu", "subphaser_torch"]
COMPAT = dict(
    trimal_options="-gt 0.9",
    tesorter_options="-bogus-flag",
    heatmap_options='scale="column", main="T", trace="none"',
    ggtree_options="branch.length='keep', layout='rectangular'",
    aligner_options="-x asm5 -n 25 -g 50000",
)
PARSED = ["heatmap_kw", "trim_gt", "tree_boot", "tree_branch_lengths",
          "block_min_anchors", "block_max_gap", "max_evalue", "pass2_rule",
          "pass2_enabled"]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_flags")
    make_genome(str(d), n_sets=2, chrom_size=60_000)
    return d


def _pipeline_cls(package: str):
    if package == "subphaser_tpu":
        from subphaser_tpu.phase.pipeline import Pipeline

        return Pipeline
    from subphaser_torch.phase.pipeline import Pipeline

    return lambda *a, **kw: Pipeline(*a, device="cpu", **kw)


def _build(package, base, tmp_path, **kw):
    return _pipeline_cls(package)(
        [str(base / "genome.fa.gz")], [str(base / "sg.config")],
        outdir=str(tmp_path / "out"), tmpdir=str(tmp_path / "tmp"), **kw)


def _messages(caplog, package):
    return [r.getMessage() for r in caplog.records
            if r.name == package and r.levelno >= logging.WARNING]


def _compat_run(package, base, tmp_path, caplog, **extra):
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger=package):
        pipe = _build(package, base, tmp_path, disable_ltrtree=True,
                      disable_circos=True, **dict(COMPAT, **extra))
    return pipe, _messages(caplog, package)


@pytest.mark.parametrize("aligner", ["minimap2", "unimap"])
@pytest.mark.parametrize("package", PACKAGES)
def test_external_aligner_errors(base, tmp_path, package, aligner):
    with pytest.raises(ValueError) as exc:
        _build(package, base, tmp_path, aligner=aligner)
    want = (f"-aligner {aligner}: external aligners are not bundled in {package}; "
            "use -aligner native (anchor-chain aligner with PAF output)")
    assert str(exc.value) == want


@pytest.mark.parametrize("package", PACKAGES)
def test_compat_flags_warn(base, tmp_path, caplog, package):
    """What tests/test_flags.py asserts of the JAX package, for each."""
    pipe, msgs = _compat_run(package, base, tmp_path, caplog)
    assert pipe.trim_gt == 0.9
    assert not any("-trimal_options '-gt'" in m for m in msgs)
    assert any("tesorter_options" in m and "bogus" in m for m in msgs)
    assert pipe.heatmap_kw == {"scale": "column", "title": "T"}
    assert any("heatmap_options" in m and "trace" in m for m in msgs)
    assert pipe.tree_branch_lengths is True
    assert any("layout" in m for m in msgs)
    assert pipe.block_min_anchors == 25 and pipe.block_max_gap == 50000
    assert any("aligner_options -x" in m for m in msgs)
    assert pipe.alt_sgs == pipe.sgs


@pytest.mark.parametrize("extra", [
    {},
    dict(tree_method="iqtree", tree_options="-B 500 --fast", trimal_options="-automated1",
         heatmap_options="xlab=kmers, labCol=T, key=F, scale=bogus",
         ggtree_options="branch.length=none, layout=circular, size=2",
         aligner_options="-x asm20 -q 3"),
])
def test_port_parses_options_as_the_jax_package(base, tmp_path, caplog, extra):
    """Same attributes, same warnings, in the same order."""
    runs = {}
    for package in PACKAGES:
        runs[package] = _compat_run(package, base, tmp_path / package, caplog, **extra)
    (jax_pipe, jax_msgs), (pipe, msgs) = runs["subphaser_tpu"], runs["subphaser_torch"]
    for name in PARSED:
        assert getattr(pipe, name) == getattr(jax_pipe, name), name
    assert msgs == jax_msgs
    assert [sorted(sg) for sg in pipe.alt_sgs] == [sorted(sg) for sg in jax_pipe.alt_sgs]


def test_alt_cfgs_parse(base, tmp_path):
    """-alt_cfgs is parsed into alt_sgs (here: each row's subgenome columns
    reversed)."""
    lines = [line for line in (base / "sg.config").read_text().splitlines()
             if line and not line.startswith("#")]
    alt = tmp_path / "alt.config"
    alt.write_text("".join("\t".join(line.split("\t")[::-1]) + "\n" for line in lines))
    got = {}
    for package in PACKAGES:
        pipe = _build(package, base, tmp_path / package, disable_ltrtree=True,
                      disable_circos=True, alt_cfgs=[str(alt)],
                      chr_ordered="order.txt")
        assert pipe.chr_ordered == "order.txt"
        assert pipe.alt_sgs != pipe.sgs
        got[package] = pipe.alt_sgs
    assert got["subphaser_torch"] == got["subphaser_tpu"]


def test_tree_defaults_without_kwargs(base, tmp_path):
    """A library caller that passes neither gets the JAX defaults."""
    jax_pipe, pipe = (_build(p, base, tmp_path / p, disable_circos=True) for p in PACKAGES)
    assert pipe.subsample == jax_pipe.subsample == 1000
    assert pipe.ltr_domains == jax_pipe.ltr_domains == ["INT", "RT", "RH"]


@pytest.mark.parametrize("error", ["host", "kernel", "cuda_fault"])
def test_tree_step_guard(base, tmp_path, monkeypatch, caplog, error):
    """A host failure of the tree step is logged and the run goes on (the
    JAX package's behaviour); a KernelError is raised, and so is a failure
    after which the card reports a fault."""
    import torch

    from subphaser_torch import kernels
    from subphaser_torch.ltr import tree

    def fail(*_args, **_kwargs):
        raise {"kernel": kernels.KernelError("launch failed"),
               "cuda_fault": RuntimeError("CUDA error: an illegal memory access"),
               "host": ValueError("bad newick")}[error]

    def faulted(_device):
        raise kernels.KernelError("CUDA error after a kernel launch")

    monkeypatch.setattr(tree, "build_ltr_trees", fail)
    monkeypatch.setattr(kernels, "synchronize", faulted)
    pipe = _build("subphaser_torch", base, tmp_path, disable_circos=True)
    pipe.enriched_ltrs, pipe.para_prefix = [object()], str(tmp_path / "p")
    if error != "host":
        if error == "cuda_fault":
            pipe.device = torch.device("cuda", 0)
        with pytest.raises(kernels.KernelError):
            pipe._step_ltr_tree(None, {}, {})
        return
    with caplog.at_level(logging.WARNING, logger="subphaser_torch"):
        pipe._step_ltr_tree(None, {}, {})
    assert "LTR tree step failed: bad newick" in _messages(caplog, "subphaser_torch")
    assert "ltr_tree" in pipe.step_seconds
