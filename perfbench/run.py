"""The benchmark of subphaser_torch: one run of one cell.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the cell's end-to-end metrics (``--trace
0``) or its per-layer metrics (``--trace 1``) as the last line of standard
output, one JSON object, after the numbers compared with the plain
reference on standard error. Exits 3 without a result where CUDA or the
cell's cards are missing, and 4 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "subphaser_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # caches at fixed paths inside the checkout; no JAX through transformers-style imports
    cache = os.path.join(ROOT, "perfbench", "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    from perfbench import harness

    bench, cell, _cfg, _traffic = harness.cell_spec(ROOT, args.workload)
    chips = int(cell["chips"])
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", ",".join(str(i) for i in range(chips)))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    res = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_start=T_START)
    found = forbidden_modules()
    if found:
        print("perfbench: JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 4

    run = res["run"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "memory_peak_bytes": int(run.peak_bytes),
              "power_limit_w": power_limit_w()}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"], "device": device}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    from perfbench.compare import LIMITS

    line["checks"] = {name: {"value": value, "limit": LIMITS[name]}
                      for name, value in res["numbers"].items()}
    print("perfbench: " + json.dumps(
        {"setup_s": run.setup_s, "window_s": run.window_s, "jobs": [[j.seconds, j.bytes_written, j.step_seconds, j.host]
                                             for j in run.jobs],
         **run.extra}),
        file=sys.stderr)
    for err in res["errors"]:
        print(f"perfbench: a job failed: {err}", file=sys.stderr)
    for name, value in res["numbers"].items():
        print(f"check {name} {value} limit {LIMITS[name]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
