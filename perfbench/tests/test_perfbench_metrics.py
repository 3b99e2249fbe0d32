"""The metric arithmetic on synthetic runs and traces: the rate over whole
jobs, the sort roofline's bytes, the device-busy union and idle gaps."""

import pytest

from perfbench import harness, tracing


def _job(seconds, bases=480_000_000, traced=False, **steps):
    return harness.Job(seconds=seconds, bases=bases, step_seconds=steps, bytes_written=0,
                       files_key="k", traced=traced)


def _run(jobs, window_s, **kw):
    return harness.Run(setup_s=30.0, window_s=window_s, jobs=jobs, peak_bytes=3 * 2**30,
                       sort_launches=kw.pop("sort_launches", 0), **kw)


def test_rate_counts_whole_jobs_over_the_whole_window():
    run = _run([_job(12.0), _job(13.0), _job(14.0)], window_s=40.0)
    assert harness.reader("phase_mbp_s")(run) == pytest.approx(3 * 480 / 40.0)
    failed = harness.Job(seconds=5.0, bases=480_000_000, step_seconds={}, bytes_written=0,
                         files_key=None)
    run = _run([_job(12.0), failed], window_s=17.0)
    assert harness.reader("phase_mbp_s")(run) == pytest.approx(480 / 17.0)


def test_peak_and_setup_readers():
    run = _run([_job(12.0)], window_s=12.0)
    assert harness.reader("peak_mem_gib")(run) == 3.0
    assert harness.reader("setup_s")(run) == 30.0


def test_step_means_leave_out_the_traced_job():
    run = _run([_job(40.0, traced=True, pack=9.0), _job(12.0, pack=4.0), _job(12.0, pack=5.0)],
               window_s=64.0, sort_launches=399)
    assert harness.reader("pack_s")(run) == pytest.approx(4.5)
    assert harness.reader("count_s")(run) is None
    assert harness.reader("sort_launches")(run) == pytest.approx(133.0)
    alone = _run([_job(40.0, traced=True, pack=9.0)], window_s=40.0)
    assert harness.reader("pack_s")(alone) == 9.0


def test_roofline_counts_eight_bytes_a_key_at_the_hbm_rate():
    keys = 2**27 * 6
    trace = tracing.TraceSummary(window_s=10.0, busy_s=2.0, sort_spans=6,
                                 sort_spans_launched=6, sort_keys=keys, sort_device_s=0.01)
    run = _run([_job(12.0)], window_s=12.0, trace=trace, trace_sort_launches=6)
    want = 100 * 8 * keys / 3.35e12 / 0.01
    assert harness.reader("sort_int32_pow2_roofline")(run) == pytest.approx(want)
    assert harness.reader("device_idle_share")(run) == pytest.approx(80.0)
    # a trace that lost a sort the program counted reports neither
    lost = _run([_job(12.0)], window_s=12.0, trace=trace, trace_sort_launches=7)
    assert harness.reader("sort_int32_pow2_roofline")(lost) is None
    assert harness.reader("device_idle_share")(lost) is None


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def synthetic_trace():
    """Steps pack [0, 100), count [100, 300), map [300, 400) us; kernels and
    copies overlapping in count, one sort span with two launches."""
    return [
        _x("subphaser step pack 0.0001", "user_annotation", 100, 0),
        _x("subphaser step count 0.0002", "user_annotation", 300, 0),
        _x("subphaser step map 0.0001", "user_annotation", 400, 0),
        _x("perfbench sort_int32_pow2 1024", "user_annotation", 150, 20),
        _x("perfbench sort_int32_pow2 1024", "gpu_user_annotation", 150, 90),
        _x("cudaLaunchKernel", "cuda_runtime", 155, 2, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 160, 2, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 250, 2, correlation=3),
        _x("radix_hist", "kernel", 170, 30, correlation=1),
        _x("radix_scatter", "kernel", 190, 50, correlation=2),
        _x("Memcpy DtoH", "gpu_memcpy", 230, 40),
        _x("other", "kernel", 330, 20, correlation=3),
    ]


def test_trace_union_gaps_and_sort_attribution():
    t = tracing.summarize(synthetic_trace())
    assert t.window_s == pytest.approx(400e-6)
    # busy: [170, 270) and [330, 350)
    assert t.busy_s == pytest.approx(120e-6)
    assert dict((n, s) for n, s in t.device_ops)["radix_scatter"] == pytest.approx(50e-6)
    gaps = {(name, round(s * 1e6)) for name, s in t.idle_gaps}
    assert gaps == {("pack", 170), ("count", 60), ("map", 50)}  # by their midpoints
    assert (t.sort_spans, t.sort_spans_launched, t.sort_keys) == (1, 1, 1024)
    assert t.sort_device_s == pytest.approx(70e-6)  # [170, 240)


def test_trace_without_device_events_is_none():
    events = [e for e in synthetic_trace() if e["cat"] not in tracing.DEVICE_CATS]
    assert tracing.summarize(events) is None


def test_interval_helpers():
    assert tracing.merge([(5, 7), (1, 3), (2, 4)]) == [[1, 4], [5, 7]]
    assert tracing.union_length([(0, 10), (5, 15)], 2, 12) == 10
    assert tracing.gaps([(2, 3), (5, 6)], 0, 8) == [(0, 2), (3, 5), (6, 8)]
