"""BENCHMARK.json against the benchmark's rules: names, units, keys, the
files each entry names, and a reader for every metric."""

import json
import os
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench):
    names = [c["name"] for c in bench["configs"]]
    assert len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/configs/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and key in cfg["published"]
            assert cfg[key] != cfg["published"][key]
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_workloads(bench):
    configs = {c["name"] for c in bench["configs"]}
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(names)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        path = os.path.join(ROOT, "perfbench", "traffic", w["traffic"] + ".json")
        with open(path) as f:
            traffic = json.load(f)
        assert "options" in traffic
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(names) // 4)


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"] for m in bench["end_to_end"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(names)) == len(names) and "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        layers.setdefault(m["layer"], m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics", m["name"] + ".py"))


def test_files_under_paths_are_named_from_name_characters(bench):
    for base in bench["paths"]:
        for d, _, files in os.walk(os.path.join(ROOT, base)):
            if "_cache" in d or "__pycache__" in d:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), ROOT)
                assert PATH.match(rel), rel
