"""Whole runs of the harness on the CPU at a tiny size: the program's files
against the plain reference for both configurations' shapes and both mixes,
and no JAX loaded in the process that prints the result."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT
from perfbench import compare, harness

SEED = 2**31 + 4242


@pytest.mark.parametrize("cell", ["tiny_ab.core_k15", "tiny_abd.core_k17"])
def test_program_equals_reference(tiny_root, cell):
    res = harness.run_cell(tiny_root, cell, SEED, 0.5, trace=False, device="cpu")
    assert res["numbers"] == dict.fromkeys(compare.LIMITS, 0)
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"phase_mbp_s", "setup_s"}  # no card: no peak memory
    run = res["run"]
    assert run.extra["kmer_mat_rows"] > 1000 and run.extra["sig_kmers"] > 100
    for job in run.jobs:  # the host's counters over each job
        assert job.host["cpu_s"] > 0 and all(v >= 0 for v in job.host.values())


def test_traced_run_reports_step_metrics(tiny_root):
    res = harness.run_cell(tiny_root, "tiny_abd.core_k15", SEED + 1, 0.5, trace=True,
                           device="cpu")
    assert res["correct"]
    assert {"pack_s", "count_s", "filter_s", "cluster_s", "map_s", "enrich_s",
            "sort_launches"} <= set(res["metrics"])
    # the CPU trace has no device events: the device metrics stay out
    assert "device_idle_share" not in res["metrics"]


SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.run import forbidden_modules
res = harness.run_cell({tiny!r}, "tiny_abd.core_k15", {seed}, 0.5, trace=False, device="cpu")
print(json.dumps({{"correct": res["correct"], "numbers": res["numbers"],
                   "forbidden": forbidden_modules(),
                   "loaded": sorted(m for m in sys.modules if m.startswith("subphaser"))}}))
"""


def test_no_jax_after_a_run(tiny_root):
    code = SCRIPT.format(root=ROOT, tiny=tiny_root, seed=SEED + 2)
    env = dict(os.environ, TMPDIR=os.path.join(tiny_root, "tmp"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=tiny_root, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["forbidden"] == []
    assert "subphaser_torch.phase.pipeline" in res["loaded"]
    assert not any(m.split(".")[0] == "subphaser_tpu" for m in res["loaded"])


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                          "--workload", "wheat_abd.core_k15", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_in_a_tree_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and perfbench/ gives no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                          "wheat_abd.core_k15", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
