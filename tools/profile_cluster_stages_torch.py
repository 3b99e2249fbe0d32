"""What each step of the cluster kernel costs on one CUDA card.

The cluster kernel of subphaser_torch/csrc/sort_primitives.cu
(``cluster_stages``: K3 and K4's lists of stages, one 2^18-key block a
cluster of 8 CTAs) runs any list of strides 2^0..2^17 through
``sp_run_stages_cluster``. This script times lists made of one kind of
step, each repeated, on 2^25 keys, and prints the time a step adds over
the empty list (a read and a write of the array):

- ``reg``: a register stage (stride 2^7, layout L1, no change of layout);
- ``warp``: a change of layout inside warps (L0 <-> L1) and a stage;
- ``cta``: a change of layout across warps (L1 <-> L2) and a stage;
- ``run2`` / ``run4`` / ``run8``: a cross-CTA run over 2, 4 or 8 CTAs
  (strides 2^15; 2^16, 2^15; 2^17, 2^16, 2^15) and a stage in L1;
- ``flip``: the complement of the keys whose index has a given bit set
  (K3 does one between phases; here a direction bit, two a list).

Then K3 (``block_sort_unrolled``) itself, and its count of each step,
beside the sum those counts predict, and the six K4 lists. Times: median of
5 CUDA-event timings after a warm-up. Needs a CUDA card.

Usage:  python tools/profile_cluster_stages_torch.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from subphaser_torch.device import resolve_device  # noqa: E402
from subphaser_torch.ops import sort_primitives as sp  # noqa: E402

N = 1 << 25
REPS = 24  # repetitions of a step in a list
# step -> (a list of strides (bits) repeated REPS times, the steps and the
# register stages one repetition holds)
STEPS = {
    "reg": ([7], 1, 0),
    "warp": ([0, 7], 2, 2),   # L1 -> L0, L0 -> L1
    "cta": ([12, 7], 2, 2),   # L1 -> L2, L2 -> L1
    "run2": ([15, 7], 1, 1),  # each run reads back in L1
    "run4": ([16, 15, 7], 1, 1),
    "run8": ([17, 16, 15, 7], 1, 1),
}
# K3's schedule at 2^25 (tests/test_torch_sort_cluster_layout.py counts it):
# register stages, changes of layout inside / across warps, runs by group
K3_COUNTS = {"reg": 165, "warp": 20, "cta": 13, "run2": 1, "run4": 1, "run8": 1, "flip": 19}


def time_ms(fn, reps: int = 5) -> float:
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run_list(x: torch.Tensor, bits, dir_bit: int = -1) -> torch.Tensor:
    return sp._launch("block_map", "sp_run_stages_cluster", x, x.numel(), bytes(bits),
                      len(bits), dir_bit)


def measure(x: torch.Tensor) -> dict:
    base = time_ms(lambda: run_list(x, []))
    per_step = {}
    for name, (bits, steps, regs) in STEPS.items():
        ms = time_ms(lambda: run_list(x, bits * REPS))
        per_step[name] = ((ms - base) / REPS - regs * per_step.get("reg", 0.0)) / steps
    per_step["flip"] = (time_ms(lambda: run_list(x, [7], 20))
                        - time_ms(lambda: run_list(x, [7]))) / 2
    k3 = time_ms(lambda: sp.block_sort_unrolled(x))
    lists = {name: time_ms(lambda: sp.block_map(name, x)) for name in sp.STAGE_BITS}
    return {"clusters_that_fit": sp.clusters_that_fit(x.numel()),
            "empty_list_ms": base, "ms_per_step": per_step, "k3_ms": k3,
            "k3_predicted_ms": base + sum(K3_COUNTS[k] * per_step[k] for k in K3_COUNTS),
            "k4_ms": lists}


def main() -> dict:
    resolve_device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (N,), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    res = measure(x)
    if not torch.equal(sp.block_sort_unrolled(x), sp.block_sort_plain(x, sp.BLOCK_BITS)):
        raise RuntimeError("K3 disagrees with its plain version")
    res = dict(res, card=smi.strip(), n=N)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
