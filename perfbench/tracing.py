"""Reduction of one job's torch.profiler trace (the program's ``-trace``
Chrome trace) to device-busy time, idle gaps, top device operations and the
device time of the sorts the harness marked.

Times in the trace are microseconds on one clock. The job's window runs
from the start of its first step (the program marks each step's end and
length as ``subphaser step <name> <seconds>``) to the later of its last
step's end and its last device event.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_MARK = "subphaser step "
SORT_SPAN = "perfbench sort_int32_pow2 "
NAME_CHARS = 160  # device operation names are cut to this length


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)   # [[name, seconds]], longest first
    idle_gaps: list = field(default_factory=list)    # [[step, seconds]], longest first
    sort_spans: int = 0             # harness spans around sort_int32_pow2 calls
    sort_spans_launched: int = 0    # of them, spans in which a launch was traced
    sort_keys: int = 0
    sort_device_s: float = 0.0


def merge(intervals):
    """Sorted, non-overlapping union of (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_length(intervals, lo=float("-inf"), hi=float("inf")) -> float:
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


def gaps(intervals, lo: float, hi: float):
    """(start, end) of the idle stretches of [lo, hi] between intervals."""
    out, cur = [], lo
    for a, b in merge(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def summarize(events: list[dict], top: int = 10) -> TraceSummary | None:
    """None where the trace holds no step mark or no device event."""
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    steps = []
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and name.startswith(STEP_MARK):
            _, _, step, seconds = name.split(" ")
            end = e["ts"] + e.get("dur", 0)
            steps.append((end - float(seconds) * 1e6, end, step))
    if not device or not steps:
        return None
    dev_iv = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in device]
    lo = min(s for s, _, _ in steps)
    hi = max(max(e for _, e, _ in steps), max(b for _, b in dev_iv))
    by_name: dict[str, float] = {}
    for e in device:
        name = e["name"][:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + e.get("dur", 0) / 1e6
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]

    def step_at(t):
        for s, e, step in steps:
            if s <= t <= e:
                return step
        return "between steps"

    idle = sorted(((step_at((a + b) / 2), (b - a) / 1e6) for a, b in gaps(dev_iv, lo, hi)),
                  key=lambda x: -x[1])[:top]
    out = TraceSummary(window_s=(hi - lo) / 1e6, busy_s=union_length(dev_iv, lo, hi) / 1e6,
                       device_ops=[[n, s] for n, s in ops], idle_gaps=[[n, s] for n, s in idle])

    # the sorts: kernels whose launch (by correlation id) lies in a sort span
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0), int(e["name"].split(" ")[2]))
                   for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(SORT_SPAN))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    sort_iv, launched = [], set()
    for e in events:
        if e.get("cat") != "kernel":
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for i, (a, b, _keys) in enumerate(spans):
            if a <= t <= b:
                sort_iv.append((e["ts"], e["ts"] + e.get("dur", 0)))
                launched.add(i)
                break
    out.sort_spans = len(spans)
    out.sort_spans_launched = len(launched)
    out.sort_keys = sum(keys for _, _, keys in spans)
    out.sort_device_s = union_length(sort_iv) / 1e6
    return out


def load_dir(trace_dir: str) -> list[dict]:
    """The events of the one Chrome trace in ``trace_dir``."""
    paths = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(paths) != 1:
        raise RuntimeError(f"expected one trace in {trace_dir}, found {len(paths)}")
    with open(paths[0]) as f:
        return json.load(f)["traceEvents"]
