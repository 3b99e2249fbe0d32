"""The cell of the pair-code path (k > 15): the readers it reports, which
read the program's pair-path spans and counter (``count/runs`` and
``count/merge`` at the int32 path's paths, so counting's readers read them
at any k) and give nothing where a program has none, and a tiny CPU run of
the harness whose counting takes
``PairSpectrumAccumulator`` (the budget lowered under a chromosome, as a
14 Gb genome's chromosomes are above it), held to the plain reference."""

import pytest

from perfbench import compare, harness

SEED = 2**31 + 1717
READERS = {
    "count_runs_device_s": "count/runs@device",
    "count_merge_device_s": "count/merge@device",
    "map_pair_search_device_s": "map/search@device",
}
ROOFLINE = "pair_sort_int64_roofline"
KEYS, SORT = "count/sort@int64_keys", "count/sort@device"


def _job(steps, traced=False):
    return harness.Job(seconds=40.0, bases=1_020_000_000, step_seconds=steps,
                       bytes_written=0, files_key="k", traced=traced)


def _run(jobs):
    return harness.Run(setup_s=70.0, window_s=90.0, jobs=jobs, peak_bytes=0, sort_launches=0)


# what a job of the parent records at k 17: steps and the passes that
# every k shares, no pair-path span, no counter
PARENT = {"pack": 8.0, "count": 15.0, "count/stage": 0.2, "count/save": 0.1,
          "filter": 8.0, "cluster": 8.0, "map": 4.0, "map/sort": 0.1,
          "map/runs": 0.01, "map/runs@device": 0.002}


@pytest.mark.parametrize("name,key", sorted(READERS.items()))
def test_reader_takes_the_mean_of_its_path(name, key):
    run = _run([_job({key: 9.0, "count": 40.0}, traced=True), _job({key: 1.0}),
                _job({key: 2.0, "pack": 5.0})])
    assert harness.reader(name)(run) == pytest.approx(1.5)  # the traced job left out
    assert harness.reader(name)(_run([_job({key: 9.0}, traced=True)])) == 9.0


@pytest.mark.parametrize("name", sorted(READERS) + [ROOFLINE])
def test_reader_gives_nothing_for_a_program_without_the_pair_spans(name):
    assert harness.reader(name)(_run([_job(PARENT), _job(dict(PARENT))])) is None
    assert harness.reader(name)(_run([_job({})])) is None


@pytest.mark.parametrize("name,key", sorted(READERS.items()))
def test_device_readers_do_not_read_host_seconds(name, key):
    host = key.removesuffix("@device")
    assert harness.reader(name)(_run([_job({host: 3.0})])) is None


def test_roofline_is_sixteen_bytes_a_key_over_the_sort_seconds():
    read = harness.reader(ROOFLINE)
    keys = 11 * (1 << 24)  # eleven batches of 2^24 keys
    run = _run([_job({KEYS: 5 * keys, SORT: 9.0}, traced=True),
                _job({KEYS: keys, SORT: 0.04}), _job({KEYS: keys, SORT: 0.06})])
    assert read(run) == pytest.approx(100 * 16 * keys / 3.35e12 / 0.05)
    assert 0 < read(run) <= 100


@pytest.mark.parametrize("steps", [{KEYS: 1 << 24}, {SORT: 0.05},
                                   {KEYS: 1 << 24, SORT: 0.0}, {KEYS: 0, SORT: 0.05},
                                   {KEYS: 1 << 24, "count/sort": 0.05}],
                         ids=["no_span", "no_counter", "zero_seconds", "zero_keys",
                              "host_seconds_only"])
def test_roofline_gives_nothing_without_both_readings(steps):
    assert harness.reader(ROOFLINE)(_run([_job(steps)])) is None


@pytest.mark.parametrize("budget,spills", [(1 << 17, False), (1 << 16, True)],
                         ids=["device_merges", "host_spill"])
def test_accumulator_path_equals_reference(tiny_root, monkeypatch, budget, spills):
    """The tiny k 17 cell with the device budget lowered under its 300 kb
    chromosomes' 327,680 positions: every chromosome is counted by
    per-batch sorts and device merges (2^17: the merged spectra stay on the
    card, as in the 1.02 Gb cell; 2^16: they also spill to the host), and
    the files equal the reference's."""
    from subphaser_torch.ops import count_pair
    from subphaser_torch.phase import pipeline

    plan = pipeline.plan_budgets

    def low_budget(*args, **kwargs):
        tile, _budget, low_mem, batch = plan(*args, **kwargs)
        return tile, budget, low_mem, batch

    seen = {"merges": 0, "spilled": []}
    merge = count_pair.merge_rle_many_pair
    finish = count_pair.PairSpectrumAccumulator.finish

    def counted_merge(parts, lower_count=1):
        if len(parts) > 1 or lower_count > 1:
            seen["merges"] += 1
        return merge(parts, lower_count)

    def spy_finish(self, lower_count=1):
        seen["spilled"].append(len(self.spilled))
        return finish(self, lower_count)

    monkeypatch.setattr(pipeline, "plan_budgets", low_budget)
    monkeypatch.setattr(count_pair, "merge_rle_many_pair", counted_merge)
    monkeypatch.setattr(count_pair.PairSpectrumAccumulator, "finish", spy_finish)
    res = harness.run_cell(tiny_root, "tiny_abd.core_k17", SEED, 0.5, trace=False,
                           device="cpu")
    assert res["numbers"] == dict.fromkeys(compare.LIMITS, 0)
    assert res["correct"] and res["failed"] == 0
    jobs = 1 + res["attempted"]  # the warm job and the window's
    assert len(seen["spilled"]) == 6 * jobs  # every chromosome of every job
    assert seen["merges"] >= len(seen["spilled"])
    assert any(seen["spilled"]) == spills and all(seen["spilled"]) == spills
    for job in res["run"].jobs:
        assert {"count/merge", "count/merge/compact", "count/collect",
                "map/search"} <= set(job.step_seconds)
        assert job.step_seconds[KEYS] == 6 * 5 * 65536  # 5 tiles of 2^16 a chromosome
