"""A short run of a real cell on the card (skips without one)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                          "--workload", "wheat_abd.core_k15", "--seed", "2147483999",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"phase_mbp_s", "peak_mem_gib", "setup_s"}
