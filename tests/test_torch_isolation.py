"""The PyTorch port stands alone: it imports neither jax nor the JAX
package, and its entry points run on CUDA unless the caller asks for the CPU."""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "subphaser_torch"
TOOL = ROOT / "tools" / "bench_sort_primitives_torch.py"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__main__.py"
)
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|subphaser_tpu)\b", re.M)


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'subphaser_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import subphaser_torch\n"
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('tool', {str(TOOL)!r})\n"
        "tool = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(tool)\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_no_jax_or_reference_package_in_sources():
    files = (list(PORT.rglob("*.py")) + list((PORT / "csrc").iterdir())
             + [ROOT / "chip_smoke.py", TOOL, TOOL.with_name("profile_sort_primitives_torch.py"),
                TOOL.with_name("profile_cluster_stages_torch.py"),
                TOOL.with_name("profile_warp_stages_torch.py"),
                TOOL.with_name("ab_phase_main.py"), TOOL.with_name("bench_runs_torch.py")])
    assert len(files) > 35
    names = {p.name for p in files}
    assert {"kmer_pair.py", "count_pair.py", "mapbins_pair.py", "sort_primitives.py",
            "sort_primitives.cu", "radix_sort.cu", "bitonic_sort.cu", "hmm_scan.cu",
            "ltr_native.cpp", "records.py", "native.py", "detect.py", "classify.py",
            "age.py", "features.py", "colors.py", "msa.py", "tree.py",
            "tree_counts.cu", "anchors.py", "anchors.cu", "align.py", "cs.py", "paf.py",
            "circos.py", "profiling.py", "runs.cu", "bench_runs_torch.py"} <= names
    for path in files:
        text = path.read_text()
        assert not _FORBIDDEN.search(text), path
        assert "subphaser_tpu" not in text, path


def test_pipeline_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from subphaser_torch.device import resolve_device
    from subphaser_torch.phase.pipeline import Pipeline

    cfg = tmp_path / "sg.config"
    cfg.write_text("A1|c1\tB1|c2\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Pipeline(["genome.fa"], [str(cfg)], disable_ltr=True, disable_circos=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_cli_defaults_to_cuda():
    from subphaser_torch.cli import make_parser

    args = make_parser().parse_args(["-i", "g.fa", "-c", "sg.config"])
    assert args.device == "cuda"


@pytest.mark.parametrize("n", [8, 1 << 14])  # the block-sort and the radix route
def test_sort_wrapper_refuses_other_devices(n):
    from subphaser_torch.ops.sort_smem import bitonic_sort_int32_pow2, sort_int32_pow2

    for fn in (sort_int32_pow2, bitonic_sort_int32_pow2):
        with pytest.raises(ValueError, match="device"):
            fn(torch.zeros(n, dtype=torch.int32, device="meta"))


def test_every_kernel_source_is_built_and_wrapped():
    """Each csrc/*.cu and csrc/*.cpp is a build target (nvcc and g++), the
    sort sources are loaded by the sort wrappers (no library sort on the
    radix route), and the run kernel by ops/count, whose run passes and
    mapping's take no prefix maximum."""
    from subphaser_torch import kernels

    assert {pathlib.Path(p).name for p in kernels.SOURCES.values()} == {
        p.name for p in (PORT / "csrc").iterdir() if p.suffix in (".cu", ".cpp")}
    assert {pathlib.Path(kernels.SOURCES[n]).suffix for n in kernels.HOST_SOURCES} == {".cpp"}
    text = (PORT / "ops" / "sort_smem.py").read_text()
    assert 'kernels.load("radix_sort")' in text and 'kernels.load("bitonic_sort")' in text
    route = text[text.index("def _radix_kernel_call"):text.index("def bitonic_sort_int32_pow2")]
    for banned in ("torch.sort", "argsort", "cumsum", "unique"):
        assert banned not in route, banned
    cu = (PORT / "csrc" / "radix_sort.cu").read_text()
    for banned in ("cub", "thrust"):
        assert not re.search(rf"#include\s*<{banned}", cu), banned
    assert 'kernels.load("runs")' in (PORT / "ops" / "count.py").read_text()
    for name in ("count.py", "mapbins.py"):
        assert "cummax" not in (PORT / "ops" / name).read_text(), name


def test_primitive_wrappers_refuse_other_devices():
    from subphaser_torch.ops import sort_primitives as sp
    from subphaser_torch.ops.sort_smem import block_sort

    x = torch.zeros(sp.BLOCK, dtype=torch.int32, device="meta")
    for fn in (sp.block_sort_unrolled, sp.descent_masked, sp.descent_grid2d, block_sort,
               lambda t: sp.block_map("passthrough", t)):
        with pytest.raises(ValueError, match="device"):
            fn(x)


def test_tool_runs_on_the_card_only(monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench_sort_primitives_torch", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tool.main(["passthrough"])


def test_pair_code_entry_points_default_to_cuda():
    import inspect

    from subphaser_torch.ops.mapbins_pair import map_genome_bins_pair

    assert inspect.signature(map_genome_bins_pair).parameters["device"].default == "cuda"


def test_hmm_scan_wrappers_take_the_plain_version_on_the_cpu_only():
    """The scan wrappers call their plain version in their CPU branch and
    nowhere else; on a CUDA tensor they launch csrc/hmm_scan.cu by the route
    scan_route picks, counting the launch by route."""
    text = (PORT / "ltr" / "classify.py").read_text()
    assert 'kernels.load("hmm_scan")' in text

    def body_of(fn):
        body = text[text.index(f"def {fn}("):]
        return body[: body.index("\ndef ")]

    for name, args in (("viterbi_scan", "res, n_valid, ms, tmm"), ("ssv_scan", "res, n_valid, ms")):
        body = body_of(name)
        assert body.count(f"{name}_plain(") == 1
        assert f'if res.device.type == "cpu":\n        return {name}_plain({args}' in body
        launch_fn = f"_{name.split('_')[0]}_launch"
        assert f"return {launch_fn}(scan_route(m), " in body
        launch = body_of(launch_fn)
        assert f'launches["{name}"] += 1' in launch
        assert f'route_launches["{name}"][kind] += 1' in launch
        assert "_plain(" not in launch


def test_ltr_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a card the LTR step's entry points raise unless asked for
    the CPU."""
    from subphaser_torch.io.genome import PackedGenome
    from subphaser_torch.ltr import classify, detect
    from subphaser_torch.ltr.pipeline import LTRPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = PackedGenome.from_dict({"c": "ACGT" * 100})
    with pytest.raises(RuntimeError, match="CUDA"):
        detect.detect_ltr(g)
    with pytest.raises(RuntimeError, match="CUDA"):
        LTRPipeline(g, str(tmp_path))
    prof = classify.Profile(name="x/RT", length=1, match_scores=np.zeros((2, 20)),
                            **{t: np.zeros(2) for t in ("tmm", "tmi", "tmd", "tim",
                                                        "tii", "tdm", "tdd")})
    with pytest.raises(RuntimeError, match="CUDA"):
        classify.ProfileStack([prof])
    assert classify.ProfileStack([prof], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module,name", [("msa", "match_counts"), ("tree", "inter_counts")])
def test_tree_count_wrappers_take_the_plain_version_on_the_cpu_only(module, name):
    """The LTR trees' count wrappers call their plain version in their CPU
    branch and nowhere else; on a CUDA tensor they launch
    csrc/tree_counts.cu (no library matmul or search), count the launch
    under a lock and raise KernelError when the launch fails."""
    assert 'kernels.load("tree_counts")' in (PORT / "ltr" / "msa.py").read_text()
    text = (PORT / "ltr" / f"{module}.py").read_text()
    body = text[text.index(f"def {name}("):]
    body = body[: body.index("\ndef ")]
    assert body.count(f"{name}_plain(") == 1
    cpu = 'if aln.device.type == "cpu":' if name == "match_counts" else \
        'if pad.device.type == "cpu":'
    assert f"{cpu}\n        return {name}_plain(" in body
    cuda = body[body.index(f"return {name}_plain("):]
    for banned in ("torch.matmul", "@", "searchsorted", "_plain("):
        assert banned not in cuda.split("\n", 1)[1], banned
    assert "lib = tree_counts_lib()" in cuda
    assert f'launches["{name}"] += 1' in cuda and "with _launch_lock:" in cuda
    assert "raise KernelError(" in cuda


@pytest.mark.parametrize("name,cpu", [("sampled_anchors", 'if words.device.type == "cpu":'),
                                      ("match_emit", 'if qc.device.type == "cpu":')])
def test_anchor_wrappers_take_the_plain_version_on_the_cpu_only(name, cpu):
    """The blocks' anchor wrappers call their plain version in their CPU
    branch and nowhere else; on a CUDA tensor they launch csrc/anchors.cu
    (no library sort, search or nonzero), count the launch under a lock and
    raise KernelError when a launch fails."""
    text = (PORT / "ops" / "anchors.py").read_text()
    assert 'kernels.load("anchors")' in text
    body = text[text.index(f"def {name}("):]
    body = body[: body.index("\ndef ")]
    assert body.count(f"{name}_plain(") == 1
    assert f"{cpu}\n        return {name}_plain(" in body
    cuda = body[body.index(f"return {name}_plain("):].split("\n", 2)[2]
    for banned in ("torch.sort", "searchsorted", "nonzero", "cumsum", "_plain(", "repeat_interleave"):
        assert banned not in cuda, banned
    assert "lib = anchors_lib()" in cuda and f'_count_launch("{name}")' in cuda
    assert "_check(lib, err" in cuda
    launch = text[text.index("def _count_launch("):text.index("def _aligned(")]
    assert "with _launch_lock:" in launch and "launches[name] += 1" in launch
    assert "raise KernelError(" in text[text.index("def _check("):text.index("def _count_launch(")]


def test_circos_and_blocks_modules_import_without_matplotlib():
    code = ("import sys\nsys.modules['matplotlib'] = None\n"
            "import subphaser_torch.viz.circos, subphaser_torch.blocks.align\n"
            "import subphaser_torch.phase.pipeline\nprint('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
