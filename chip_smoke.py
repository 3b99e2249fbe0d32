#!/usr/bin/env python3
"""Smoke test of the PyTorch port (subphaser_torch) on one CUDA card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:

1. build    compile every CUDA kernel of the port from csrc/ (nvcc, in
            parallel) and print the build seconds;
2. sort     the production sort (block sort up to 2^13 keys, the radix kernel
            above) against both plain PyTorch versions (the radix schedule
            and the bitonic network, on the card) and against torch.sort,
            bit-exact, at n = 2, 2^10, 2^18 (half SENTINEL), 2^23 and 2^27;
            at 2^23 and 2^27 on three inputs: keys from n/8 values, full-range
            keys with negatives, and 99.9% SENTINEL. Also the whole bitonic
            sort kernel at every size against its plain network (timed at
            2^23 and 2^27). Prints
            kernel/plain/library times (CUDA events, median after a warm-up;
            a plain version at 2^27 by the host clock of its one checking
            call) and the bytes bound;
3. primitives  the sort-primitives tool (tools/bench_sort_primitives_torch.py)
            at its full size, 128 blocks of 2^18 keys, with the launch counts
            read around it (the whole bitonic and radix sorts are candidates
            of it too); then every kernel behind it bit-exact against its
            plain version on the card (tool inputs and full-range keys),
            block_sort_unrolled also against block_sort, descent18 of a
            bitonic input against torch.sort; prints each kernel's and plain
            version's time and the bytes bound;
4. parity   the port's CLI on a 12 Mb wheat-like genome on the card and on
            the CPU (plain versions), at k = 15 and at k = 17 (pair codes):
            the five count/map/enrich files must be byte-identical and the
            subgenome assignments equal;
5. main     the port's CLI at real size: tools/gen_wheat_scale.py 2 80, a
            480 Mb allohexaploid (2 homoeologous sets x A/B/D x 80 Mb), with
            -min_freq 200 and the default 1000 bootstrap replicates. All six
            chromosomes must phase by subgenome with bootstrap >= 90, the
            dense mapping path must run, and the sort kernel must launch.
            Prints seconds per step, Mbp/s and peak device memory.
6. main_k17 the same genome and options at -k 17: pair codes (int64 keys)
            through counting and the searchsorted mapping path. Same checks,
            and the significant k-mers must be 17 letters of ACGT.

The last lines are the card's name and power limit (nvidia-smi), one JSON
object describing each kernel, and the result object.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "_smoke")  # git-ignored scratch: genomes, outputs
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
SORT_SIZES = [2, 1 << 10, 1 << 18, 1 << 23, 1 << 27]
MAIN_SETS, MAIN_CHROM_MB = 2, 80
CORE_FILES = [".kmer.mat", ".chrom-subgenome.tsv", ".sig.kmer-subgenome.tsv",
              ".subgenome.bin.count", ".bin.enrich", ".bin.group"]


def tpu_kernel_site(pattern: str, needle: str) -> str:
    """file:line of the first line starting with ``needle`` in the file
    matching ``pattern``: the Pallas kernel a CUDA kernel replaces (read as
    text from the same checkout)."""
    import glob

    for path in sorted(glob.glob(os.path.join(ROOT, *pattern.split("/")))):
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if line.startswith(needle):
                    return f"{os.path.relpath(path, ROOT)}:{i}"
    raise RuntimeError(f"the TPU kernel's source ({needle!r}) was not found")


SORT_VMEM = "*/ops/sort_vmem.py"
JAX_TOOL = "tools/bench_sort_primitives.py"
# kernel (= launch counter) of the primitives path -> (TPU kernel site, the
# tool's candidates it serves, the first being the one whose times it reports)
PRIMITIVE_KERNELS = {
    "block_sort_unrolled": (SORT_VMEM, "def _block_sort_kernel(", ["block_sort_unrolled"]),
    "block_map": (JAX_TOOL, "def pallas_block_map(", [
        "descent18", "passthrough", "elementwise30", "lane_roll_stages",
        "sublane_reshape_vreg", "sublane_reshape_small", "sublane_roll_stages",
        "transpose8"]),
    "descent_masked": (JAX_TOOL, "def _descent_masked(", ["descent18_masked"]),
    "descent_grid2d": (JAX_TOOL, "def _descent_grid2d(", ["descent18_grid2d"]),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` on the card (CUDA events), after one
    warm-up call."""
    import torch

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


def phase_build() -> None:
    from subphaser_torch import kernels

    t0 = time.perf_counter()
    seconds = kernels.build(force=True, verbose=True)
    log(f"phase build ok: {json.dumps(seconds)} ({time.perf_counter() - t0:.1f} s wall)")


def phase_sort() -> dict:
    """Returns {"radix": {n: {input kind: row}}, "bitonic": {n: row}}."""
    import torch

    from subphaser_torch.ops import sort_smem

    sort_input = load_tool().sort_input
    rows = {"radix": {}, "bitonic": {}}
    for n in SORT_SIZES:
        big = n >= 1 << 23
        huge = n >= 1 << 27
        bound_ms = 8 * n / HBM_BYTES_PER_S * 1e3
        rows["radix"][n] = {}
        for kind in ("uniform", "full_range", "skewed") if big else ("uniform",):
            x = sort_input(kind, n, "cuda")
            if n == 1 << 18:
                x[n // 2:] = sort_smem.SENTINEL
            keep = x.clone()
            got = sort_smem.sort_int32_pow2(x)
            lib = torch.sort(x).values
            torch.cuda.synchronize()
            if not torch.equal(x, keep):
                raise RuntimeError(f"the sort wrote its input at n={n} ({kind})")
            del keep
            # the plain versions are timed by the call that checks them
            # where one call takes seconds
            t0 = time.perf_counter()
            ok = torch.equal(got, sort_smem.radix_sort_plain(x))
            radix_plain_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ok = ok and torch.equal(got, sort_smem.bitonic_sort_plain(x))
            bitonic_plain_ms = (time.perf_counter() - t0) * 1e3
            if not ok or not torch.equal(got, lib):
                raise RuntimeError(f"sort kernel disagrees at n={n} ({kind})")
            row = {
                "max_abs_err": int((got.long() - lib.long()).abs().max()),
                "kernel_ms": time_ms(lambda: sort_smem.sort_int32_pow2(x)),
                "library_ms": time_ms(lambda: torch.sort(x)),
                "plain_ms": radix_plain_ms if huge else time_ms(
                    lambda: sort_smem.radix_sort_plain(x), 1 if big else 3),
                "bitonic_plain_ms": bitonic_plain_ms if huge else time_ms(
                    lambda: sort_smem.bitonic_sort_plain(x), 3),
                "bound_ms": bound_ms,
            }
            rows["radix"][n][kind] = row
            log(f"sort n={n} {kind} " + json.dumps(row))
            if kind == "uniform":
                # the whole bitonic sort, the block-structured counterpart of
                # K1+K2: held at every size (`got` equals its plain network,
                # checked above), timed at the two sizes of the main path
                before = sort_smem.bitonic_launches
                got_b = sort_smem.bitonic_sort_int32_pow2(x)
                torch.cuda.synchronize()
                if sort_smem.bitonic_launches != before + 1 or not torch.equal(got_b, got):
                    raise RuntimeError(f"bitonic sort kernel disagrees at n={n}")
                rows["bitonic"][n] = {
                    "max_abs_err": int((got_b.long() - lib.long()).abs().max()),
                    "bound_ms": bound_ms,
                }
                if big:
                    rows["bitonic"][n].update(
                        kernel_ms=time_ms(lambda: sort_smem.bitonic_sort_int32_pow2(x)),
                        library_ms=row["library_ms"],
                        plain_ms=row["bitonic_plain_ms"],
                    )
                log(f"sort n={n} bitonic " + json.dumps(rows["bitonic"][n]))
                del got_b
            del x, got, lib
    torch.cuda.empty_cache()
    log("phase sort ok: bit-exact against both plain versions and torch.sort "
        f"at n = {', '.join(str(n) for n in SORT_SIZES)}")
    return rows


def load_tool():
    """The sort-primitives tool as a module (tools/ is not a package)."""
    path = os.path.join(ROOT, "tools", "bench_sort_primitives_torch.py")
    spec = importlib.util.spec_from_file_location("bench_sort_primitives_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_primitives() -> tuple[dict, dict]:
    """Returns ({candidate: row}, {launch counter: launches of the tool's run});
    the whole bitonic sort's counter is among them as ``bitonic_sort``."""
    import torch

    from subphaser_torch.ops import sort_primitives as sp
    from subphaser_torch.ops import sort_smem

    tool = load_tool()
    for name in sp.launches:
        sp.launches[name] = 0
    sort_smem.bitonic_launches = 0
    tool_rows = tool.main([])
    launches = dict(sp.launches, bitonic_sort=sort_smem.bitonic_launches)
    idle = [name for name, count in launches.items() if count <= 0]
    if idle:
        raise RuntimeError(f"the tool's run launched no kernel of {idle}")

    x_tool = tool.make_input(tool.N_BLOCKS, torch.device("cuda")) ^ 1
    n = x_tool.numel()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    x_full = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen, device="cuda",
                           dtype=torch.int64).to(torch.int32)
    x_full[::1001] = -(1 << 31)
    plains = sp.plain_versions()
    rows = {}
    for name, fn in sp.candidates().items():
        err = 0
        for x in (x_tool, x_full):
            got, want = fn(x), plains[name](x)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"primitive {name} disagrees with its plain version")
            err = max(err, int((got.long() - want.long()).abs().max()))
            del got, want
        rows[name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: fn(x_tool)),
            "plain_ms": time_ms(lambda: plains[name](x_tool), 3),
            "bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3,
            "tool_ms": tool_rows[name]["ms"],
        }
        log(f"primitive {name} " + json.dumps(rows[name]))
    for name in ("bitonic_sort", "radix_sort", "torch_sort"):
        log(f"primitive {name} tool_ms={tool_rows[name]['ms']}")
    if not torch.equal(sp.block_sort_unrolled(x_full), sort_smem.block_sort(x_full)):
        raise RuntimeError("block_sort_unrolled disagrees with block_sort")
    halves = x_tool.view(tool.N_BLOCKS, 2, -1)
    bitonic = torch.cat([halves[:, 0].sort(dim=1).values,
                         halves[:, 1].sort(dim=1, descending=True).values], dim=1)
    got = sp.block_map("descent18", bitonic.reshape(-1)).view(tool.N_BLOCKS, -1)
    if not torch.equal(got, bitonic.sort(dim=1).values):
        raise RuntimeError("descent18 of a bitonic block disagrees with torch.sort")
    del x_tool, x_full, halves, bitonic, got
    torch.cuda.empty_cache()
    log(f"phase primitives ok: {len(rows)} candidates bit-exact at n = {n}; "
        f"tool launches {json.dumps(launches)}")
    return rows, launches


def gen_genome(out: str, n_sets: int, chrom_mb: float) -> tuple[str, str]:
    os.makedirs(out, exist_ok=True)
    subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "gen_wheat_scale.py"),
         out, str(n_sets), str(chrom_mb)],
        check=True, stdout=subprocess.DEVNULL,
    )
    return (os.path.join(out, f"genome14_1_{n_sets}.fa"),
            os.path.join(out, "sg14.config"))


def run_cli(fa: str, cfg: str, out: str, *extra: str):
    from subphaser_torch import cli

    return cli.main(["-i", fa, "-c", cfg, "-o", os.path.join(out, "out"),
                     "-tmpdir", os.path.join(out, "tmp"), "-disable_ltr",
                     "-disable_circos", "-disable_blocks", *extra])


def read_assignments(pipe) -> dict[str, tuple[str, int]]:
    path = pipe.para_prefix + ".chrom-subgenome.tsv"
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if not line.startswith("#")]
    return {r[0]: (r[1], int(r[2])) for r in rows}


def check_phased(assign: dict[str, tuple[str, int]]) -> None:
    """Chromosomes are named <subgenome letter><set>: each letter must map
    to one SG, distinct letters to distinct SGs, all with support >= 90."""
    by_letter: dict[str, set] = {}
    for chrom, (sg, _bs) in assign.items():
        by_letter.setdefault(chrom[0], set()).add(sg)
    sgs = [next(iter(v)) for v in by_letter.values() if len(v) == 1]
    if len(sgs) != len(by_letter) or len(set(sgs)) != len(sgs):
        raise RuntimeError(f"chromosomes not phased by subgenome: {assign}")
    low = {c: bs for c, (_sg, bs) in assign.items() if bs < 90}
    if low:
        raise RuntimeError(f"bootstrap support below 90: {low}")


def phase_parity() -> None:
    fa, cfg = gen_genome(os.path.join(WORK, "small"), 2, 2)
    for k in (15, 17):
        args = ("-k", str(k), "-min_freq", "4", "-lower_count", "2",
                "-tile_bases", str(1 << 20), "-replicates", "100")
        gpu = run_cli(fa, cfg, os.path.join(WORK, "small", f"cuda{k}"), *args)
        cpu = run_cli(fa, cfg, os.path.join(WORK, "small", f"cpu{k}"), *args, "-device", "cpu")
        for suffix in CORE_FILES:
            if suffix == ".chrom-subgenome.tsv":
                continue
            with open(gpu.para_prefix + suffix, "rb") as a, \
                    open(cpu.para_prefix + suffix, "rb") as b:
                if a.read() != b.read():
                    raise RuntimeError(f"k={k}: {suffix} differs between cuda and cpu runs")
        a_gpu, a_cpu = read_assignments(gpu), read_assignments(cpu)
        if {c: v[0] for c, v in a_gpu.items()} != {c: v[0] for c, v in a_cpu.items()}:
            raise RuntimeError(f"k={k}: assignments differ: cuda {a_gpu} cpu {a_cpu}")
        check_phased(a_gpu)
    log("phase parity ok: 12 Mb genome at k = 15 and k = 17, cuda == cpu on the five "
        "count/map/enrich files and the assignments")


def phase_main(k: int = 15) -> dict:
    """The 480 Mb run at ``k``: phase ``main`` (k = 15, int32 codes, dense
    mapping table) or ``main_k17`` (pair codes, searchsorted mapping)."""
    import torch

    from subphaser_torch.ops import sort_smem

    phase = "main" if k == 15 else f"main_k{k}"
    genome_dir = os.path.join(WORK, "main")
    fa = os.path.join(genome_dir, f"genome14_1_{MAIN_SETS}.fa")
    cfg = os.path.join(genome_dir, "sg14.config")
    if not os.path.exists(fa):
        t0 = time.perf_counter()
        fa, cfg = gen_genome(genome_dir, MAIN_SETS, MAIN_CHROM_MB)
        log(f"main genome generated in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sort_smem.launches = 0
    for route in sort_smem.route_launches:
        sort_smem.route_launches[route] = 0
    t0 = time.perf_counter()
    pipe = run_cli(fa, cfg, os.path.join(WORK, phase), "-k", str(k), "-min_freq", "200")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sort_smem.launches
    by_route = dict(sort_smem.route_launches)
    for suffix in CORE_FILES:
        if not os.path.getsize(pipe.para_prefix + suffix):
            raise RuntimeError(f"empty output {suffix}")
    check_phased(read_assignments(pipe))
    if pipe.map_dense != (k <= 15):
        raise RuntimeError(f"{phase}: wrong mapping path (dense={pipe.map_dense})")
    if by_route["radix"] <= 0 or sum(by_route.values()) != launches:
        raise RuntimeError(f"the radix sort kernel was not launched on the {phase} path: "
                           f"{by_route} of {launches}")
    with open(pipe.para_prefix + ".sig.kmer-subgenome.tsv") as f:
        kmers = [line.split("\t", 1)[0] for line in f if not line.startswith("#")]
    if not kmers or any(len(km) != k or set(km) - set("ACGT") for km in kmers):
        raise RuntimeError(f"{phase}: significant k-mers are not {k} letters of ACGT")
    mbp = pipe.genome.total_bases() / 1e6
    steps = {k: round(v, 3) for k, v in pipe.step_seconds.items()}
    result = {
        "genome_mbp": mbp,
        "wall_s": round(wall, 3),
        "step_s": steps,
        "count_mbp_per_s": mbp / pipe.step_seconds["count"],
        "map_mbp_per_s": mbp / pipe.step_seconds["map"],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "sort_launches": launches,
        "sort_launches_by_route": by_route,
        "sig_kmers": len(kmers),
        "assignments": read_assignments(pipe),
    }
    log(f"{phase} " + json.dumps(result))
    log(f"phase {phase} ok: {mbp:.0f} Mb phased at k = {k}, "
        f"{'dense' if pipe.map_dense else 'searchsorted'} mapping, {launches} sort launches")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check", file=sys.stderr)
        return 2
    from subphaser_torch.device import resolve_device

    resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        phase_build()
        sort_rows = phase_sort()
        prim_rows, prim_launches = phase_primitives()
        phase_parity()
        main_res = phase_main(15)
        k17_res = phase_main(17)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(smi)
    by_path = {route: {"main": main_res["sort_launches_by_route"][route],
                       "main_k17": k17_res["sort_launches_by_route"][route]}
               for route in ("radix", "block_sort")}
    radix = {f"2^{n.bit_length() - 1}": by_kind for n, by_kind in sort_rows["radix"].items()
             if n > 1 << 13}
    row = sort_rows["radix"][1 << 27]["uniform"]
    kernels = [{
        "name": "radix_sort_int32",
        "route": "cuda",
        "source": "subphaser_torch/csrc/radix_sort.cu",
        "replaces": tpu_kernel_site(SORT_VMEM, "def _block_sort_kernel_grid"),
        "launches": by_path["radix"]["main"],
        "launches_by_path": by_path["radix"],
        "max_abs_err": max(r["max_abs_err"] for by_kind in radix.values()
                           for r in by_kind.values()),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": row["library_ms"],
        "by_size": radix,  # 2^23: all but a few of the launches of either path
    }]
    row = sort_rows["bitonic"][1 << 27]
    kernels.append({
        "name": "bitonic_sort_int32",
        "route": "cuda",
        "source": "subphaser_torch/csrc/bitonic_sort.cu",
        "replaces": tpu_kernel_site(SORT_VMEM, "def _descent_kernel"),
        "launches": prim_launches["bitonic_sort"],  # the tool's run; on no phasing path
        "launches_by_path": {"primitives": prim_launches["bitonic_sort"], "main": 0,
                             "main_k17": 0},
        # its block_sort kernel alone is the production sort's route up to 2^13 keys
        "block_sort_launches_by_path": by_path["block_sort"],
        "max_abs_err": max(r["max_abs_err"] for r in sort_rows["bitonic"].values()),
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "bytes",
        "library_ms": row["library_ms"],
        "by_size": {f"2^{n.bit_length() - 1}": r for n, r in sort_rows["bitonic"].items()},
    })
    # one entry per kernel of the primitives path; block_map's own numbers
    # are its full descent (descent18), every candidate's are inside
    for name, (pattern, needle, cand_names) in PRIMITIVE_KERNELS.items():
        cands = {c: prim_rows[c] for c in cand_names}
        lead = cands[cand_names[0]]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "subphaser_torch/csrc/sort_primitives.cu",
            "replaces": tpu_kernel_site(pattern, needle),
            "launches": prim_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in cands.values()),
            "ms": lead["ms"],
            "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "candidates": cands,
        })
    unrolled = next(k for k in kernels if k["name"] == "block_sort_unrolled")
    unrolled["block_sort_ms"] = prim_rows["block_sort"]["ms"]  # the looped twin
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
