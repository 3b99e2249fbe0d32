"""The run-length kernel of ops/count (csrc/runs.cu) on one CUDA card.

At the shapes of the counting paths it checks ``run_scan`` + ``run_compact``
bit for bit against their plain version (``run_scan_plain``, on the card)
and times them against the bytes bound, the plain version and the
``torch.cummax`` chain they replaced (start and end masks, the prefix
maximum of the run starts, the keep mask, a boolean select and the pads;
for pair codes the chain of ops/count_pair, with its hi-word pad test and
the split into hi and lo):

- ``batch_2^24``: 2^24 keys, run lengths, lower 1, cap = n: one ``sort_rle``
  of a low-memory batch (4 tiles of 2^22 positions);
- ``fast_2^27``: 2^27 keys, lower 3, cap 2^23: ``count_codes_async`` on the
  fast path (one chromosome a sort);
- ``merge_2^28``: 2^28 weighted entries, lower 1, cap from the survivor
  count: a merge of ``SpectrumAccumulator`` (a 2^27 budget pre-merged);
- ``pair_batch_2^24``: 2^24 int64 pair codes, run lengths, lower 1, cap n:
  one batch of ``PairSpectrumAccumulator`` at k > 15 (``rn_count64`` +
  ``rn_write64``);
- ``pair_merge_2^28``: 2^28 weighted pair codes, lower 1, cap from the
  survivor count: a merge of ``PairSpectrumAccumulator``;
- ``pair_fast_2^27``: 2^27 pair codes, lower 3, cap from the survivor
  count, a PAD64 run of 2^27 - 80,000,000: ``count_pair_codes_threshold``
  on the fast path (one 80 Mb chromosome a sort, as in chip_smoke.py's
  phase ``main_k17``).

Keys are sorted draws: three quarters from n/3 values (runs of a few), one
quarter from n/4096 values (runs of ~1,000 that cross the kernel's 4,096-key
tiles), and a trailing SENTINEL run (1% of the keys, as a tile's invalid
positions; 5 million at 2^27; the pow2 pad of an 80 Mb chromosome on the
pair fast path). Pair codes map each such value v to
hi = v // 2, lo = (v + 1) // 2 (neighbouring runs differ in one word), the
SENTINEL run to PAD64. Weights are 0..3 (zeros test the rule total > 0).
Times: CUDA events around one call, median of 5 after a warm-up
(``kernel_ms``: both launches; ``count_ms``: the count launch alone, what
the ``runs`` span holds); the plain version and the cummax chain the same
way below 2^28 and once by CUDA events at 2^28. The bound: 4 n bytes of
int32 keys or 8 n of pair codes, 4 n of weights, and 8 bytes an output
slot (12: a pair's two words and its total) at 3.35 TB/s.

Usage (needs a CUDA card; raises without one):

    python tools/bench_runs_torch.py [shape ...]
"""

from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from subphaser_torch.ops import count  # noqa: E402
from subphaser_torch.ops.kmer import SENTINEL  # noqa: E402
from subphaser_torch.ops.kmer_pair import PAD64, split64_t  # noqa: E402

HBM_BYTES_PER_S = 3.35e12
# shape -> (n, weighted, lower, cap: an int, or None for the merge's
# survivor-sized cap, SENTINEL run, pair codes)
SHAPES = {
    "batch_2^24": (1 << 24, False, 1, 1 << 24, (1 << 24) // 100, False),
    "fast_2^27": (1 << 27, False, 3, 1 << 23, 5_000_000, False),
    "merge_2^28": (1 << 28, True, 1, None, (1 << 28) // 100, False),
    "pair_batch_2^24": (1 << 24, False, 1, 1 << 24, (1 << 24) // 100, True),
    "pair_merge_2^28": (1 << 28, True, 1, None, (1 << 28) // 100, True),
    "pair_fast_2^27": (1 << 27, False, 3, None, (1 << 27) - 80_000_000, True),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def sorted_keys(n: int, sentinel_run: int, seed: int, pair: bool = False) -> torch.Tensor:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    short = torch.randint(0, max(n // 3, 1), (n - n // 4,), generator=gen, device="cuda",
                          dtype=torch.int32)
    long = torch.randint(0, max(n // 4096, 1), (n // 4,), generator=gen, device="cuda",
                         dtype=torch.int32) * 4099
    keys = torch.sort(torch.cat([short, long])).values
    if pair:
        v = keys.long()
        del keys
        keys = (v // 2) << 31 | (v + 1) // 2
        keys[n - sentinel_run:] = PAD64
        return keys
    keys[n - sentinel_run:] = SENTINEL
    return keys


def weights_for(n: int, seed: int) -> torch.Tensor:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    return torch.randint(0, 4, (n,), generator=gen, device="cuda", dtype=torch.int32)


def kernel_call(keys, weights, lower: int, cap):
    runs = count.run_scan(keys, weights, lower)
    return count.run_compact(runs, count._out_cap(int(runs.m), keys.numel())
                             if cap is None else cap), runs.m


def _padded(keys, total, cap):
    """Survivors padded to ``cap``: (keys, totals), the keys of pair codes a
    (2, cap) tensor of hi and lo, as ``run_compact`` writes them."""
    if keys.dtype == torch.int64:
        return torch.stack(split64_t(count._pad_to(keys, cap, PAD64))), count._pad_to(total, cap, 0)
    return count._pad_to(keys, cap, SENTINEL), count._pad_to(total, cap, 0)


def plain_call(keys, weights, lower: int, cap):
    kept_keys, kept_tot = count.run_scan_plain(keys, weights, lower)
    m = kept_keys.numel()
    cap = count._out_cap(m, keys.numel()) if cap is None else cap
    return _padded(kept_keys, kept_tot, cap), m


def cummax_call(keys, weights, lower: int, cap):
    """The chain the kernel replaced (ops/count before it; ops/count_pair's
    for int64 pair codes, whose pad test reads the hi word), same outputs."""
    n = keys.numel()
    start = torch.ones(n, dtype=torch.bool, device=keys.device)
    start[1:] = keys[1:] != keys[:-1]
    end = torch.ones(n, dtype=torch.bool, device=keys.device)
    end[:-1] = keys[:-1] != keys[1:]
    if weights is None:
        iota = torch.arange(n, dtype=torch.int32, device=keys.device)
        total = iota - torch.cummax(torch.where(start, iota, -1), 0).values + 1
    else:
        csum = torch.cumsum(weights, 0, dtype=torch.int64)
        total = csum - torch.cummax(torch.where(start, csum - weights, -1), 0).values
    live = (keys >> 31 if keys.dtype == torch.int64 else keys) != SENTINEL
    keep = end & (total >= lower) & live & (total > 0)
    m = keep.sum()
    cap = count._out_cap(int(m), n) if cap is None else cap
    return _padded(keys[keep], total[keep].to(torch.int32), cap), m


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


def run_shape(name: str, seed: int = 18) -> dict:
    n, weighted, lower, cap, sentinel_run, pair = SHAPES[name]
    keys = sorted_keys(n, sentinel_run, seed, pair)
    weights = weights_for(n, seed) if weighted else None
    launches0 = dict(count.entry_launches)
    got, m_dev = kernel_call(keys, weights, lower, cap)
    torch.cuda.synchronize()
    launched = {e: count.entry_launches[e] - launches0[e] for e in launches0}
    want = ({"rn_count64": 1, "rn_write64": 1} if pair else {"rn_count": 1, "rn_write": 1})
    if {e: d for e, d in launched.items() if d} != want:
        raise RuntimeError(f"{name}: launches {launched}")
    ref, m = plain_call(keys, weights, lower, cap)
    old, m_old = cummax_call(keys, weights, lower, cap)
    ok = (int(m_dev) == m == int(m_old) and all(torch.equal(a, b) for a, b in zip(got, ref))
          and all(torch.equal(a, b) for a, b in zip(got, old)))
    if not ok:
        raise RuntimeError(f"{name}: the kernel disagrees with its plain version")
    out_slots = got[-1].numel()
    key_bytes, slot_bytes = (8, 12) if pair else (4, 8)
    bound_ms = ((key_bytes + (4 if weighted else 0)) * n
                + slot_bytes * out_slots) / HBM_BYTES_PER_S * 1e3
    del got, ref, old
    reps = 1 if n >= 1 << 28 else 5
    row = {
        "keys": "int64 pair codes" if pair else "int32",
        "n": n, "weighted": weighted, "lower": lower, "m": m, "cap": out_slots,
        "sentinel_run": sentinel_run,
        "max_abs_err": 0,
        "kernel_ms": time_ms(lambda: kernel_call(keys, weights, lower, cap)),
        "count_ms": time_ms(lambda: count.run_scan(keys, weights, lower)),
        "bound_ms": bound_ms,
        "plain_ms": time_ms(lambda: plain_call(keys, weights, lower, cap), reps),
        "cummax_ms": time_ms(lambda: cummax_call(keys, weights, lower, cap), reps),
    }
    row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    del keys, weights
    torch.cuda.empty_cache()
    return row


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_runs_torch needs a CUDA card")
    log(f"device {torch.cuda.get_device_name(0)} torch {torch.__version__}")
    for name in argv or list(SHAPES):
        log(f"runs {name} " + json.dumps(run_shape(name)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
