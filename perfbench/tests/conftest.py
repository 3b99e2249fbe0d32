"""Fixtures of the benchmark's CPU tests: a checkout root holding a
BENCHMARK.json whose cells run tiny genomes on the CPU."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_OPTIONS = ["-q", "4", "-lower_count", "2", "-replicates", "50", "-tile_bases", "65536"]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


def tiny_config(name: str, subgenomes: str) -> dict:
    with open(os.path.join(ROOT, "perfbench", "configs", "wheat_abd.json")) as f:
        cfg = json.load(f)
    cfg.update(name=name, subgenomes=subgenomes, n_sets=2, chrom_bases=300_000,
               shared_families=12, sg_families=6)
    cfg["options"] = cfg["options"] + TINY_OPTIONS
    return cfg


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A root whose BENCHMARK.json has the real metrics and tiny cells
    ``tiny_abd.core_k15``, ``tiny_ab.core_k15`` and ``tiny_abd.core_k17``."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(tmp_path / "perfbench" / "configs")
    os.makedirs(tmp_path / "perfbench" / "traffic")
    configs = []
    for name, sgs in (("tiny_abd", "ABD"), ("tiny_ab", "AB")):
        path = f"perfbench/configs/{name}.json"
        with open(tmp_path / path, "w") as f:
            json.dump(tiny_config(name, sgs), f)
        configs.append({"name": name, "source": "tests", "file": path, "reduced": [],
                        "why": "tests"})
    for mix in ("core_k15", "core_k17"):
        with open(os.path.join(ROOT, "perfbench", "traffic", mix + ".json")) as f:
            traffic = json.load(f)
        with open(tmp_path / "perfbench" / "traffic" / (mix + ".json"), "w") as f:
            json.dump(traffic, f)
    cells = [("tiny_abd", "core_k15"), ("tiny_ab", "core_k15"), ("tiny_abd", "core_k17")]
    bench["configs"] = configs
    bench["workloads"] = [{"name": f"{c}.{t}", "config": c, "traffic": t, "chips": 1,
                           "why": "tests"} for c, t in cells]
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny_abd.core_k15", "tiny_ab.core_k15"]
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    return str(tmp_path)
