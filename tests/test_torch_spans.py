"""The span recorder (subphaser_torch/utils/profiling.py): paths of nested
spans, summed host seconds and calls, a no-op outside a job and on other
threads, no device keys on the CPU, the ``[perf]`` line at a job's end, the
counting passes' paths under counting and under mapping, the pair-code
path's spans at the same paths and its sorted-keys counter."""

import contextvars
import logging
import threading
import time

import numpy as np
import pytest
import torch

from span_paths import assert_children_within_parents, sub_spans
from subphaser_torch.utils import profiling
from subphaser_torch.utils.profiling import Spans, span

CPU = torch.device("cpu")


def test_nested_spans_join_their_names():
    rec = Spans()
    with rec.job(CPU):
        with rec.span("count"):
            with span("runs"):
                with span("inner"):
                    pass
            with span("merge"):
                with span("compact"):
                    pass
        with rec.span("circos"):
            with rec.span("blocks", top=True):
                with span("part"):
                    pass
    assert list(rec.seconds) == ["count/runs/inner", "count/runs", "count/merge/compact",
                                 "count/merge", "count", "blocks/part", "blocks", "circos"]
    assert_children_within_parents(rec.seconds)


def test_host_seconds_and_calls_add_up():
    rec = Spans()
    with rec.job(CPU):
        with span("map"):
            for _ in range(3):
                with span("write"):
                    time.sleep(0.01)
    assert rec.calls == {"map/write": 3, "map": 1}
    assert 0.03 <= rec.seconds["map/write"] <= rec.seconds["map"]
    assert_children_within_parents(rec.seconds)


def test_a_span_that_raises_is_not_recorded():
    rec = Spans()
    with rec.job(CPU):
        with span("filter"):
            with pytest.raises(ValueError):
                with span("select"):
                    raise ValueError("no k-mer")
            with span("write"):
                pass
    assert set(rec.seconds) == {"filter/write", "filter"}


def test_no_op_outside_a_job():
    assert span("count") is span("filter")  # the one shared null context
    rec = Spans()
    with span("count"):
        pass
    with rec.job(CPU):
        pass
    with span("count"):
        pass
    assert rec.seconds == {} and rec.calls == {}
    assert profiling._CURRENT.get() is None


def test_no_op_on_another_thread():
    rec = Spans()
    seen = []

    def worker():
        with span("pack_worker"):
            seen.append(profiling._CURRENT.get())

    with rec.job(CPU):
        with span("pack"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    assert seen == [None] and set(rec.seconds) == {"pack"}


def test_no_op_on_another_thread_that_shares_the_context():
    rec = Spans()
    seen = []
    with rec.job(CPU):
        ctx = contextvars.copy_context()
        t = threading.Thread(target=ctx.run,
                             args=(lambda: seen.append(span("x") is profiling._NOOP),))
        t.start()
        t.join()
        seen.append(span("x") is profiling._NOOP)
    assert seen == [True, False]


@pytest.mark.parametrize("device", [True, False])
def test_no_device_keys_on_the_cpu(device):
    rec = Spans()
    with rec.job(CPU):
        with span("count"):
            with span("runs", device=device):
                torch.cummax(torch.arange(1000), 0)
    assert set(rec.seconds) == {"count/runs", "count"}
    assert rec.peak_path is None and rec.peak_bytes == 0


def test_job_end_logs_one_perf_line(caplog):
    """Paths with their calls, and kernel launches by C entry, counted for
    the job on its thread only."""
    rec = Spans()
    profiling.count_launch("rn_count")  # outside a job: not counted
    with caplog.at_level(logging.INFO, logger="subphaser_torch"):
        with rec.job(CPU):
            with span("pack"):
                with span("read"):
                    profiling.count_launch("rn_count")
            ctx = contextvars.copy_context()
            t = threading.Thread(target=ctx.run, args=(profiling.count_launch, "rn_write"))
            t.start()
            t.join()
            profiling.count_launch("rn_count")
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("[perf]")]
    assert len(lines) == 1
    assert "pack 1 " in lines[0] and "pack/read 1 " in lines[0]
    assert rec.launches == {"rn_count": 2}
    assert lines[0].endswith("; launches rn_count 2")


def test_failed_job_logs_no_perf_line(caplog):
    rec = Spans()
    with caplog.at_level(logging.INFO, logger="subphaser_torch"):
        with pytest.raises(RuntimeError):
            with rec.job(CPU):
                raise RuntimeError("step failed")
    assert not any(r.getMessage().startswith("[perf]") for r in caplog.records)
    assert profiling._CURRENT.get() is None


def test_marks_only_while_a_profiler_records():
    rec = Spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.job(CPU):
            with span("cluster"):
                with span("tests"):
                    pass
    names = [e.name for e in prof.events() if e.name.startswith("subphaser step ")]
    assert [n.split()[2] for n in names] == ["cluster/tests", "cluster"]
    assert float(names[0].split()[3]) == rec.seconds["cluster/tests"]


@pytest.mark.parametrize("step", ["count", "map"])
def test_counting_passes_name_themselves_under_their_step(step):
    from subphaser_torch.ops.count import sort_rle

    codes = torch.from_numpy(np.random.default_rng(1).integers(0, 50, 4096, dtype=np.int32))
    rec = Spans()
    with rec.job(CPU):
        with rec.span(step):
            sort_rle(codes)
    assert set(rec.seconds) == {f"{step}/sort", f"{step}/runs", f"{step}/compact", step}


def test_merge_calls_count_the_key_value_sorts():
    from subphaser_torch.ops.count import SpectrumAccumulator

    rng = np.random.default_rng(2)
    rec = Spans()
    with rec.job(CPU):
        with rec.span("count"):
            acc = SpectrumAccumulator(device_budget=1 << 11)
            for _ in range(4):
                acc.add(*_part(rng))
            got = acc.finish(lower_count=2)
    assert rec.calls["count/merge"] == 3  # two over the budget, one at the end
    assert rec.calls["count/merge/compact"] == 3
    assert "count/merge/runs" not in rec.seconds
    assert got[0].size > 0
    assert_children_within_parents(rec.seconds)


def _part(rng):
    from subphaser_torch.ops.count import sort_rle

    return sort_rle(torch.from_numpy(rng.integers(0, 2000, 1024, dtype=np.int32)))


def test_sorts_are_called_through_the_module_names(monkeypatch):
    """A rebinding of ``sort_int32_pow2`` in ops/count (as a profiler
    wrapper does) reaches every keys-only sort of the fast path."""
    from subphaser_torch.ops import count

    calls = []
    orig = count.sort_int32_pow2

    def wrapped(x):
        calls.append(x.numel())
        return orig(x)

    monkeypatch.setattr(count, "sort_int32_pow2", wrapped)
    codes = torch.from_numpy(np.random.default_rng(3).integers(0, 99, 3000, dtype=np.int32))
    got_c, got_n = count.count_codes_threshold([codes], 2)
    assert calls == [4096]
    want_c, want_n = np.unique(codes.numpy(), return_counts=True)
    assert np.array_equal(got_c, want_c[want_n >= 2])
    assert np.array_equal(got_n, want_n[want_n >= 2])


@pytest.mark.cuda
def test_device_spans_and_the_peak_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    torch.zeros(1, device=dev)  # the allocator's statistics exist once it has allocated
    torch.cuda.reset_peak_memory_stats(dev)  # the test's own; the recorder never resets
    rec = Spans()
    with rec.job(dev):
        with rec.span("count"):
            with span("runs", device=True):
                x = torch.cummax(torch.arange(1 << 24, device=dev), 0).values
            with span("stage"):
                pass
    assert rec.seconds["count/runs@device"] > 0, rec.seconds
    assert "count/stage@device" not in rec.seconds and "count@device" not in rec.seconds
    assert rec.peak_path == "count/runs", (rec.peak_path, rec.peak_bytes)
    assert rec.peak_bytes >= 2 * x.numel() * 8, rec.peak_bytes


def _pair_tiles(seed: int, tile: int = 1024):
    """Packed tiles of a random chromosome with repeats, at k = 17."""
    from subphaser_torch.io.genome import PackedGenome

    rng = np.random.default_rng(seed)
    unit = "".join(rng.choice(list("ACGT"), 150))
    tail = "".join(rng.choice(list("ACGT"), 3000))
    g = PackedGenome.from_dict({"c": unit * 8 + tail})
    return [(torch.from_numpy(t.words), torch.from_numpy(t.vwords))
            for t in g.tiles(17, tile_bases=tile)]


def test_pair_sorts_count_the_keys_of_their_batches():
    """``count/sort@int64_keys`` adds every key of each keys-only int64 sort:
    a batch's positions on the accumulator path, the power-of-two padded
    concatenation on the fast path; the merges' key-value sorts add none."""
    from subphaser_torch.ops import count_pair

    tiles = _pair_tiles(4)
    batches = [(torch.stack([w for w, _ in tiles[i:i + 2]]),
                torch.stack([v for _, v in tiles[i:i + 2]])) for i in range(0, 4, 2)]
    rec = Spans()
    with rec.job(CPU):
        with rec.span("count"):
            acc = count_pair.PairSpectrumAccumulator(device_budget=1 << 12)
            for words, vwords in batches:
                acc.add(*count_pair.count_tile_batch_pair(words, vwords, 17, 1024 // 16))
            acc.finish(lower_count=2)
    held = sum(w.shape[0] * 1024 for w, _ in batches)
    assert rec.seconds["count/sort@int64_keys"] == held == 4096
    assert rec.calls["count/sort"] == len(batches) and rec.calls["count/merge"] >= 1

    rec = Spans()
    with rec.job(CPU):
        with rec.span("count"):
            parts = [count_pair.extract_pair_codes_batch(w, v, 17, 1024 // 16)
                     for w, v in tiles[:3]]
            count_pair.count_pair_codes_threshold(parts, 2)
    assert rec.seconds["count/sort@int64_keys"] == 4096  # 3 x 1024 keys padded
    assert "count/merge" not in rec.calls


def test_a_counter_outside_a_span_is_not_recorded(caplog):
    rec = Spans()
    profiling.count("int64_keys", 5)  # outside a job
    with caplog.at_level(logging.INFO, logger="subphaser_torch"):
        with rec.job(CPU):
            profiling.count("int64_keys", 7)  # no span open
            with span("count"):
                with span("sort"):
                    profiling.count("int64_keys", 3)
                    profiling.count("int64_keys", 4)
    assert rec.seconds["count/sort@int64_keys"] == 7
    assert set(rec.seconds) == {"count/sort", "count", "count/sort@int64_keys"}
    (line,) = [r.getMessage() for r in caplog.records if r.getMessage().startswith("[perf]")]
    assert "; counter count/sort@int64_keys 7" in line


# the nested spans every core job records, whatever its k
CORE_SPANS = {"pack/read", "pack/save", "count/key", "count/tiles", "count/stage",
              "count/save", "filter/select", "filter/write", "cluster/kmeans",
              "cluster/tests", "cluster/write", "map/sort", "map/runs", "map/write"}
INT32_SPANS = CORE_SPANS | {"count/codes", "count/sort", "count/runs", "count/compact",
                            "count/collect", "map/table", "map/compact"}
PAIR_FAST_SPANS = CORE_SPANS | {"count/codes", "count/sort", "count/runs", "count/compact",
                                "count/collect", "map/search"}
PAIR_ACC_SPANS = PAIR_FAST_SPANS | {"count/merge", "count/merge/compact"}


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    from make_synthetic import make_genome

    base = tmp_path_factory.mktemp("spans_jobs")
    genome, cfg = make_genome(str(base), n_sets=2, chrom_size=80_000)
    return base, genome, cfg


def _core_job(synthetic, k: int, budget: int | None, monkeypatch):
    """One core job on the CPU; ``budget`` replaces the device budget that
    ``plan_budgets`` gives."""
    from subphaser_torch.phase import pipeline

    base, genome, cfg = synthetic
    if budget is not None:
        plan = pipeline.plan_budgets

        def low_budget(*args, **kwargs):
            tile, _budget, low_mem, batch = plan(*args, **kwargs)
            return tile, budget, low_mem, batch

        monkeypatch.setattr(pipeline, "plan_budgets", low_budget)
    tag = f"k{k}_{budget}"
    return pipeline.Pipeline([genome], [cfg], outdir=str(base / f"out_{tag}"),
                             tmpdir=str(base / f"tmp_{tag}"), device="cpu", k=k,
                             min_freq=40, replicates=10, tile_bases=1 << 16,
                             disable_ltr=True, disable_circos=True,
                             window_size=40_000).run()


@pytest.mark.parametrize("k,budget,want", [(15, None, INT32_SPANS),
                                           (17, None, PAIR_FAST_SPANS),
                                           (17, 1 << 16, PAIR_ACC_SPANS)],
                         ids=["int32", "pair_fast", "pair_accumulator"])
def test_core_job_spans_by_counting_path(synthetic, monkeypatch, k, budget, want):
    """A k 17 job records the pair path's passes at the int32 path's paths
    (``count/merge`` on the accumulator path, a 2^16 budget under the 2^17
    positions of a chromosome), its lookups as ``map/search`` (one a tile),
    no device keys on the CPU, and the int32 path's set stays as it was."""
    pipe = _core_job(synthetic, k, budget, monkeypatch)
    seconds = pipe.step_seconds
    assert sub_spans(seconds) == want
    assert not any(p.endswith("@device") for p in seconds)
    assert_children_within_parents(seconds)
    calls = pipe.spans.calls
    tiles = list(pipe.genome.tiles(k, tile_bases=1 << 16))
    if k == 15:
        assert not any("@" in p for p in seconds)
        return
    assert calls["map/search"] == len(tiles)
    per_chrom = {}
    for t in tiles:
        per_chrom[t.chrom_index] = per_chrom.get(t.chrom_index, 0) + (1 << 16)
    if budget is None:  # one sort a chromosome, padded to a power of two
        want_keys = sum(1 << (n - 1).bit_length() for n in per_chrom.values())
    else:  # one sort a batch of one tile
        want_keys = len(tiles) << 16
        assert calls["count/merge"] >= len(per_chrom)
    assert seconds["count/sort@int64_keys"] == want_keys
