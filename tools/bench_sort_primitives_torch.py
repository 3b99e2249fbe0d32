"""Microbenchmark of bitonic-stage primitives on one CUDA card.

The PyTorch port's counterpart of tools/bench_sort_primitives.py: the same
candidates by the same names, at the same problem size (128 blocks of 2^18
int32 = 33.5M keys), each a hand-written CUDA kernel of
subphaser_torch/csrc/sort_primitives.cu behind its wrapper in
subphaser_torch/ops/sort_primitives.py. It shows what a compare-exchange
stage costs on the card by where the partner lives (registers, warp
shuffle, shared memory, device memory); that module's docstring says which
level each candidate exercises. ``torch_sort`` is the library yardstick
(the JAX tool's ``lax_sort`` line); ``torch_sort_segmented`` is the one
PyTorch call that computes K3's function (:func:`segmented_sort`). ``block_sort`` (the bitonic sort's
looped phase (a), phases 1..13) and ``block_sort_unrolled`` (K3: phases
1..18 of 2^18-key blocks, 1..13 unrolled at compile time) run beside the
JAX tool's candidates, and so do the two whole sorts
of ops/sort_smem: ``bitonic_sort`` (the comparison network the stages add
up to) and ``radix_sort`` (the production route, csrc/radix_sort.cu).

Every iteration gets a fresh salt xor-ed into the input; a candidate's time
is the median of 5 CUDA-event timings of the wrapper alone, after 2
warm-up iterations; a position-weighted checksum of each result is
printed so runs can be compared.

Usage (needs a CUDA card; raises without one):

    python tools/bench_sort_primitives_torch.py [candidate ...]
"""

from __future__ import annotations

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from subphaser_torch.device import resolve_device  # noqa: E402
from subphaser_torch.ops import sort_primitives as sp  # noqa: E402
from subphaser_torch.ops import sort_smem  # noqa: E402

N_BLOCKS = 128  # 33.5M keys in all
ITERS, WARMUP = 5, 2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def make_input(n_blocks: int, device: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(0)
    flat = rng.integers(0, 1 << 30, size=n_blocks * sp.BLOCK, dtype=np.int32)
    return torch.from_numpy(flat).to(device)


def sort_input(kind: str, n: int, device, seed: int = 2024) -> torch.Tensor:
    """Inputs of the whole sorts at the phaser's sizes. ``uniform``: keys
    drawn from n/8 values (many repeats, as counting sees); ``skewed``:
    99.9% SENTINEL, the rest full-range (as mapping sees); ``full_range``:
    any int32, INT32_MIN among them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if kind == "uniform":
        return torch.randint(0, max(n // 8, 2), (n,), generator=gen, device=device,
                             dtype=torch.int32)
    x = torch.randint(-(1 << 31), 1 << 31, (n,), generator=gen, device=device,
                      dtype=torch.int64).to(torch.int32)
    if kind == "skewed":
        x[torch.rand(n, generator=gen, device=device) >= 0.001] = sort_smem.SENTINEL
    elif kind == "full_range":
        x[::1001] = -(1 << 31)
    else:
        raise ValueError(f"unknown sort input {kind!r}")
    return x


def segmented_sort(x: torch.Tensor) -> torch.Tensor:
    """K3's function in one torch.sort: every 2^18-key block sorted, odd
    blocks descending (complemented, ~x, which reverses int32 order
    exactly); an array of one block or less sorted ascending."""
    if x.numel() <= sp.BLOCK:
        return torch.sort(x).values
    y = x.view(-1, sp.BLOCK)
    m = -(torch.arange(y.shape[0], device=x.device, dtype=torch.int32) & 1)[:, None]
    return (torch.sort(y ^ m, dim=1).values ^ m).reshape(-1)


def bench(fn, x_base: torch.Tensor, iters: int = ITERS, warmup: int = WARMUP):
    """(median seconds of ``fn(x_base ^ salt)``, checksum of the last result)."""
    w = torch.arange(x_base.numel(), dtype=torch.int64, device=x_base.device) & 1023
    times, checksum = [], 0
    for i in range(warmup + iters):
        x = x_base ^ (i + 1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        y = fn(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
        checksum = int(((y.to(torch.int64) & 0xFFFF) * w).sum())
    return statistics.median(times[warmup:]), checksum


def main(argv=None, n_blocks: int = N_BLOCKS) -> dict:
    """Times the named candidates (all by default); returns
    {name: {"ms", "ms_per_stage", "mkeys_per_s", "checksum"}}."""
    names = list(sys.argv[1:] if argv is None else argv)
    device = resolve_device("cuda")
    fns = dict(sp.candidates(), bitonic_sort=sort_smem.bitonic_sort_int32_pow2,
               radix_sort=sort_smem.sort_int32_pow2,
               torch_sort=lambda x: torch.sort(x).values,
               torch_sort_segmented=segmented_sort)
    unknown = [n for n in names if n not in fns]
    if unknown:
        raise SystemExit(f"unknown candidates {unknown}; known: {', '.join(fns)}")
    x = make_input(n_blocks, device)
    log(f"device: {torch.cuda.get_device_name(device)}, total elems: {x.numel() / 1e6:.1f}M")
    results = {}
    for name in names or list(fns):
        t, checksum = bench(fns[name], x)
        results[name] = {
            "ms": t * 1e3,
            "ms_per_stage": t * 1e3 / sp.N_STAGES,
            "mkeys_per_s": x.numel() / t / 1e6,
            "checksum": checksum,
        }
        log(f"{name:24s} run {t * 1e3:8.3f} ms ({x.numel() / t / 1e6:8.0f} M keys/s; "
            f"{t * 1e3 / sp.N_STAGES:.4f} ms/stage) checksum {checksum}")
    return results


if __name__ == "__main__":
    main()
