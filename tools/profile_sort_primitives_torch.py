"""Device time per CUDA kernel behind each sort-primitives candidate and
behind the production sort.

Companion of tools/bench_sort_primitives_torch.py: that tool times a
candidate's wrapper with CUDA events; this one runs each candidate 5 times
under ``torch.profiler`` and prints, per kernel name, the launches and the
mean device microseconds of one launch. It separates a candidate's
shared-memory tile launches from its device-memory stages, and the kernels
from the wrapper's allocation.

The names ``sort_2^23_uniform``, ``sort_2^23_skewed``, ``sort_2^27_uniform``
and ``sort_2^27_skewed`` profile ``sort_smem.sort_int32_pow2`` (the radix
kernels ``radix_hist``, ``radix_scan``, ``radix_scatter``) at the two sizes
the phaser's main path sorts, on keys drawn from n/8 values and on 99.9%
SENTINEL (the mapping path's input).

Usage (needs a CUDA card; raises without one):

    python tools/profile_sort_primitives_torch.py [name ...]
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench_sort_primitives_torch import sort_input  # noqa: E402

from subphaser_torch.device import resolve_device  # noqa: E402
from subphaser_torch.ops import sort_primitives as sp  # noqa: E402
from subphaser_torch.ops import sort_smem  # noqa: E402

N_BLOCKS = 128
REPS = 5
SORT_BITS = (23, 27)


def main(argv=None) -> dict:
    """Returns {name: {kernel name: (launches, mean device us)}}."""
    names = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device("cuda")
    fns = dict(sp.candidates())
    sort_inputs = {f"sort_2^{bits}_{kind}": (kind, 1 << bits)
                   for bits in SORT_BITS for kind in ("uniform", "skewed")}
    fns.update({name: sort_smem.sort_int32_pow2 for name in sort_inputs})
    unknown = [n for n in names if n not in fns]
    if unknown:
        raise SystemExit(f"unknown candidates {unknown}; known: {', '.join(fns)}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    x = torch.randint(0, 1 << 30, (N_BLOCKS * sp.BLOCK,), generator=gen, device=device,
                      dtype=torch.int32)
    print(f"device: {torch.cuda.get_device_name(device)}, {x.numel()} keys, "
          f"{REPS} runs per name", flush=True)
    out = {}
    x_tool = x
    for name in names or list(fns):
        x = sort_input(*sort_inputs[name], device) if name in sort_inputs else x_tool
        fns[name](x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fns[name](x)
            torch.cuda.synchronize()
        # device-side events only: kernels and device-to-device copies
        out[name] = {e.key: (e.count, e.device_time_total / e.count)
                     for e in prof.key_averages()
                     if e.device_time_total > 0 and e.cpu_time_total == 0}
        for key, (count, us) in out[name].items():
            print(f"{name:24s} {key[:60]:60s} x{count:<4d} {us:9.1f} us", flush=True)
    return out


if __name__ == "__main__":
    main()
