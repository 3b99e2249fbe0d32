#!/usr/bin/env python3
"""Smoke test of the PyTorch port (subphaser_torch) on one CUDA card.

Usage (from the repository root, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:

1. build    compile every library of the port from csrc/ (nvcc for the CUDA
            kernels, g++ for the LTR step's host library, in parallel) and
            print the build seconds;
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
2b. runs    the run-length kernel of ops/count (csrc/runs.cu: run_scan and
            run_compact) by tools/bench_runs_torch.py at 2^24 keys (a
            low-memory batch), 2^27 (the fast path, a 5-million-key
            SENTINEL run) and 2^28 weighted entries (a merge), and its
            64-bit instantiation on int64 pair codes at 2^24 keys (a batch
            at k > 15), 2^28 weighted entries (a pair merge) and 2^27 keys
            at lower 3 with a 54-million-key PAD64 run (the fast path of
            phase main_k17), bit-exact
            against its plain version and the torch.cummax chain it
            replaced; prints the three's times and the bytes bound;
3. primitives  the sort-primitives tool (tools/bench_sort_primitives_torch.py)
            at its full size, 128 blocks of 2^18 keys, with the launch counts
            read around it (the whole bitonic and radix sorts are candidates
            of it too; K3 and K4's six lists of stages must all launch the
            cluster kernel, one launch a call); then every kernel behind it
            bit-exact against its plain version on the card (tool inputs and
            full-range keys); block_sort_unrolled (K3, phases 1..18 of 2^18-key
            blocks, a cluster of 8 CTAs a block) and its library call (one
            segmented torch.sort) against block_sort_plain(., 18) at n = 2^10,
            2^15, 2^16, 2^18, 2^19 and 2^25; descent18 of a bitonic input
            against torch.sort; K5 and K6 (descent_masked, descent_grid2d:
            one launch of the warp kernel a call) at one block, 3 blocks and
            the tool's 128, on the tool's keys and on full-range keys, and K5
            on 512-key bitonic groups against a per-group torch.sort. Prints
            how many clusters fit on the card, each kernel's, plain
            version's and K3's library time, and the bytes and operations
            bounds (int32 min/max at 128 a clock an SM, at the card's
            maximum SM clock; a block sort's operations
            are log2(block) a key, its bitonic network's count is shown
            beside the bound as network_ops_ms), and for K5 and K6 the
            kernel's device time by torch.profiler (device_ms) and
            bound_ms / device_ms (share_of_bound);
4. hmm      the classifier's two scans (viterbi_scan, ssv_scan of
            csrc/hmm_scan.cu) bit-exact against their plain versions on the
            card, at B = 1024 residue rows of L = 64, 1024 and 4096, on the
            wheat fixture database (tools/gen_wheat_scale.py --hmm; also at
            B = 4096, L = 1024) and on a synthetic stack of 64 profiles of
            600 nodes with forbidden (-inf) transitions (both by the warp
            route), and at L = 1024 on 8 synthetic profiles of 1500 nodes
            (the block route); prints the route, kernel, plain and bound
            times, and on the warp route the block route's time on the same
            inputs (timed by CUDA events over back-to-back calls of ~5 ms);
5. parity   the port's CLI on a 12 Mb wheat-like genome on the card and on
            the CPU (plain versions), at k = 15 with the LTR step and its
            trees on (-hmm_db: the domain route, progressive MSA and
            bootstrap NJ), again at k = 15 without -hmm_db (the sketch
            route, from the first run's core checkpoints), and at k = 17
            (pair codes): the five count/map/enrich files, the seven LTR
            files and every tree file (.aln, .trimal, .tree.nwk, .tree.map)
            must be byte-identical, each route must write a tree, and the
            subgenome assignments must be equal; then the default run (LTR
            with trees, homoeologous blocks, circos: no -disable_*) from
            the k = 15 run's checkpoints on the card and on the CPU: every
            tmp/Blocks/*.paf must be byte-identical (cs:Z: tags included)
            and both anchor kernels must launch; and the same default run
            once more on the card with -trace: the device-busy seconds of
            each step (the summed kernel time of the torch.profiler trace
            inside the step's window) are printed. Before the default run,
            the k = 15 LTR step once more on the card from that run's
            checkpoints with SUBPHASER_FEATURE_MAP=device (the LTR k-mer
            mapping by genome tiles on the card, trees off): its four LTR
            files must be byte-identical to the host route's;
6. main     the port's CLI at real size: tools/gen_wheat_scale.py 2 80, a
            480 Mb allohexaploid (2 homoeologous sets x A/B/D x 80 Mb), with
            -min_freq 200 and the default 1000 bootstrap replicates. All six
            chromosomes must phase by subgenome with bootstrap >= 90, the
            dense mapping path must run, and the sort kernel must launch.
            Prints seconds per step, Mbp/s and peak device memory.
6b. stats   ops/stats and the PCA at real size: fisher_enrich_pvals
            (csrc/stats.cu's fisher_right_tail) through its entry point on
            phase main's .subgenome.bin.count (~48,000 bins x 3 SGs) and on
            it tiled to a 14 Gb wheat's 1.4 M bins, with the launch count
            read around the two calls; the kernel against its plain version
            on the card (bit for bit, NaN where NaN; max relative error <=
            1e-4 on p > 1e-30, the same decisions at 0.05) and the share of
            decisions at 0.05 that agree with the host float64 test
            (reported, not gated); the walks' lengths by a float32 walk of
            the script's own, to the end and to the stop the kernel's exits
            allow (max, 99th percentile, total), the bound restated on the
            terms to the stop beside the one on the terms to the end, the
            cycles a term costs on one walk's chain (the longest table
            alone, its walk whole and halved) and the floor the longest
            walk sets, and the kernels a call launches (a CUDA-graph
            capture: 2); bh_fdr,
            the t-test, Mann-Whitney and Kruskal on phase main's k-mer
            matrix, card against CPU at the CPU tests' tolerances;
            PhaseCluster.pca on the card against the CPU (scores within
            1e-3 after z-scoring in the columns whose eigenvalues are
            resolved, ratios within 1e-5). Prints the kernel's wrapper ms,
            device ms (bare launches queued behind a spin), plain ms and
            its bound: three special-function calls a term over the SFU's
            16 a clock an SM, against its float32 operations at 67 TFLOP/s
            and its bytes, on the terms to the stop (and on the terms to
            the end beside it); no single PyTorch call computes it;
7. main_k17 the same genome and options at -k 17: pair codes (int64 keys)
            through counting and the searchsorted mapping path. Same checks,
            and the significant k-mers must be 17 letters of ACGT.
8. ltr      the slice at real size: the 480 Mb genome through the CLI with
            the default LTR step, trees included (-hmm_db of its fixture
            database), in a copy of phase main's tmpdir so the core steps
            load from their checkpoints. LTRs must be found, classified and
            SG-enriched, and both scans must launch, all by the warp route;
            every superfamily group of >= 4 enriched LTRs must get a
            .tree.nwk and a .tree.map, and match_counts must launch
            (tree_boot + 1) times for each group of the alignment route,
            every launch by its bits route.
            Prints seconds of detection, classification pass 1 and 2,
            feature mapping, enrichment, ages and trees, the counts,
            launches and peak memory, per tree group its leaves and aligned
            and trimmed columns, and per scan and length bucket the
            launches, rows and ms between CUDA events around each wrapper
            call;
9. trees    on phase ltr's own data: the sketch route at real size
            (build_ltr_trees without domain peptides on the enriched LTRs:
            subsampled to 1000, 499,500 sketch pairs); the largest tree's
            bootstrap NJ rebuilt from its .trimal (it must give the same
            tree file), timed, with one NJ tree and one bipartition set
            alone: where the alignment route's time goes; match_counts
            (csrc/tree_counts.cu) bit-exact by its bits route (bit planes
            and popcounts over the columns expanded by integer weights)
            against its plain version on the largest group's trimmed
            alignment at its real n and L, with ones and with a bootstrap
            (multinomial) weight set, and against its library call (the
            one-hot products as one torch.matmul, TF32 off); its float route
            (match_counts_kernel) on fractional weights (0.7 of the bootstrap
            counts + 0.1) within 2 L 2^-24 sum(w) of its plain version (the
            worst-case error of float32 sums of L non-negative terms, taken
            in another order on each side), also through kimura_distances
            (card against CPU within 1e-3); inter_counts (a warp merge of
            each pair's rows, one launch a call) bit-exact against its plain
            version on the sketches of the first 1000 enriched LTRs' whole
            elements, all pairs, with mash_distances' matrices equal on card
            and CPU, and mash_distances' card time and host waits there
            (torch.profiler: its device events, and its synchronising calls
            and copies on the host); both at edge shapes (n = 1, 63, 65; L =
            1 and odd; sketches of 1 and of 37 values, 1536-wide rows; an
            empty sketch). Prints kernel ms (one wrapper call,
            CUDA events, median after a warm-up), device ms (the bare
            kernel launched back to back behind a spin of the card, between
            CUDA events; and by torch.profiler where it records the
            launches), plain and library ms, and the bound; for
            match_counts both routes' device ms on the same inputs, the
            bits route's bound (the larger of its bytes and its popcounts,
            two a pair and 32-column word at 16 a clock an SM) and the
            float route's (two float32 adds a pair and weighted column).
10. blocks  the default run at real size: the 480 Mb genome through the CLI
            with every step at its default (-hmm_db of its fixture
            database), in a copy of phase ltr's tmpdir (core, detection and
            classification load from their checkpoints; the trees, the
            homoeologous blocks and the circos step run). Each homoeologous
            pair of sg14.config (2 sets x 3 column pairs) must get a .paf
            with a primary record of query span >= min_block carrying
            tp:A:P and cs:Z:, and both anchor kernels must launch. Prints
            the circos and blocks seconds, the blocks step's thread-seconds
            of anchoring, join and host chaining/cs, per pair its blocks and
            query bases covered, the launches by wrapper and by C entry
            point, and peak device memory;
11. anchors the anchor kernels (csrc/anchors.cu) bit-exact against their
            plain versions on the card: sampled_anchors (kernel A) on tiles
            of phase blocks' genome at mod 16 (the first 2^23-base tile of
            A1, A1's last partial tile, a tile of invalid words, and the
            first tile at a cap below its count: the prefix and the count
            must equal the full cap's), and the kernels one call launches
            (a call captured into a CUDA graph, its kernel nodes counted:
            2, the count and the write pass), match_emit (kernel B) on the
            whole anchor sets of the pair A1-B1, with no run kept, with
            every run max_occ long, with every kept query in one tile of
            its scan, below one tile (1,000 queries) and on 2^20 + 12,345
            random queries at a random keep rate; its two C entries (the
            scan and the emit) captured into a CUDA graph: 2 kernel nodes.
            Prints each kernel's wrapper ms (CUDA events), device ms (bare
            launches queued behind a spin of the card; each kernel's passes
            also by torch.profiler where it records them), plain ms and the
            bytes bound (inputs read once, outputs written once, at 3.35
            TB/s; kernel B's compact list of kept queries printed beside
            it); no single PyTorch call computes either.
12. parallel several devices and processes on the one card, on phase main's
            genome: (1) range_slots (csrc/parallel.cu) bit-exact against its
            plain version on chromosome A1's local spectra at D = 2 and 4
            shards, and candidate_counts on a data shard's tile spectra
            (half of the 480 Mb tiles) against the candidates of phase
            genome's spectra (every occurrence counted) in phase main's
            -min_freq window, whole and halved (the meshes (2, 1) and
            (2, 2)); each kernel's wrapper, device
            (queued) and plain ms and its bound, and candidate_counts'
            kernels a call (a call captured into a CUDA graph: 2, the
            segments and the counts) with their split by torch.profiler; (2) sharded_spectrum of A1
            on meshes of 2 and 4 shards of cuda:0 (counts reset before and
            read after): after >= lower_count, phase main's A1 spectrum;
            (3) build_phase_step on meshes (2, 1) and (2, 2) of cuda:0 over
            every tile (counts reset before and read after): its counts
            equal the host's candidate matrix over the same spectra (the
            step counts every occurrence, as the JAX step does, so they are
            counted with lower_count 1), its diff flags the host filter's
            decisions at every k-mer whose fold ratio is not within 1e-6 of
            min_fold (float32 against float64 there; such ties are counted
            and printed), and its labels phase main's assignments; (4) two processes (this script with
            --parallel-worker, a gloo group on localhost, both on cuda:0):
            core phasing at 480 Mb with phase main's options (each rank's
            six core files = phase main's bytes) and the default run of
            phase parity's 12 Mb genome (each rank's data files and PAFs =
            phase parity's one-process default run's bytes), with the
            stages' "Distributed counting" / "Sharded ..." markers in both
            logs; prints each rank's wall and step seconds and the bytes and
            seconds of each exchange; (5) a dead rank: with
            SUBPHASER_COLLECTIVE_TIMEOUT=10 the survivor exits 17 within 10 s
            of entering the exchange.

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
FP32_OPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores (data sheet)
# 32-bit integer min/max/add a clock an SM: 128, the SM's 4 schedulers x 32
# lanes, the most any 32-bit instruction issues. (The CUDA C Programming
# Guide's table gives 64 for compare/min/max at compute capability 9.0, but
# on the H100 a register compare-exchange stage of the cluster kernel runs
# above that rate, and sm_90 fuses an add and a max into one instruction.)
INT32_OPS_PER_CLOCK_PER_SM = 128
# special-function unit (MUFU) results a clock an SM (CUDA C Programming
# Guide, arithmetic instruction throughput, compute capability 9.0)
SFU_OPS_PER_CLOCK_PER_SM = 16
# 32-bit population counts a clock an SM (the same table, compute capability
# 9.0): the rate match_counts' bits route is bounded by
POPC_PER_CLOCK_PER_SM = 16
# float32 operations a term of fisher_right_tail's recurrence, besides its
# three special-function calls: 8 adds and 2 products of the ratio and its
# quotient, 2 compares, the clamp, the log term's add, and logaddexp's max,
# difference, absolute value, negation, add and its -inf test
FISHER_OPS_PER_TERM = 21
# an eigenvector of a float32 gram matrix is known to ~(its relative
# error, ~1e-6 for sums of 10^6 products) / (relative gap to its neighbours):
# columns with a gap above 1e-3 are held to 1e-3
PCA_GAP = 1e-3
STATS_WHEAT_BINS = 1_400_000  # 10 kb bins of a 14 Gb wheat
STATS_KMERS = 1 << 20  # rows of phase main's k-mer matrix for the t, U and H tests
STATS_HOST_BUDGET_S = 10.0  # host float64 seconds a matrix of phase stats may take
STATS_HOST_CHUNK = 250  # rows a chunk of the host float64 sample
SORT_SIZES = [2, 1 << 10, 1 << 18, 1 << 23, 1 << 27]
MAIN_SETS, MAIN_CHROM_MB = 2, 80
CORE_FILES = [".kmer.mat", ".chrom-subgenome.tsv", ".sig.kmer-subgenome.tsv",
              ".subgenome.bin.count", ".bin.enrich", ".bin.group"]
LTR_OUT_FILES = [".ltr.bin.count", ".ltr.enrich", ".ltr.insert.data", ".ltr.insert.summary"]
LTR_TMP_FILES = ["LTR.scn", "LTR.inner.fa.cls.tsv", "LTR.filtered.LTR.fa"]
LTR_STEPS = ["ltr_detect", "ltr_classify_pass1", "ltr_classify_pass2", "ltr_map",
             "ltr_enrich", "ltr_age", "ltr_tree"]
TREE_SUFFIXES = (".aln", ".trimal", ".tree.nwk", ".tree.map")
TREE_LEAVES = 1000  # -subsample's default: the most leaves a tree has
BLOCK_STEPS = ["circos", "blocks", "blocks_anchors", "blocks_join", "blocks_chain_cs"]
ANCHOR_KERNELS = {"sampled_anchors": "def sampled_anchors(", "match_emit": "def _match_emit("}
# stack -> (profiles, nodes, seed or None for the wheat database, [(rows,
# length)]): the classifier's batches are 1024 rows; the wheat stack at 4096
# rows has four times the warps on the same code
HMM_STACKS = {"wheat": (None, None, None, [(1024, 64), (1024, 1024), (1024, 4096),
                                           (4096, 1024)]),
              "synthetic": (64, 600, 5, [(1024, 64), (1024, 1024), (1024, 4096)]),
              "wide": (8, 1500, 6, [(1024, 1024)])}
# float32 adds and maxes per (residue, node) cell, as the JAX step computes
# them: Viterbi 7 for the match state, 3 insert, 3 delete chain, 1 column
# max; SSV 2 and 1 for the running max
HMM_OPS_PER_CELL = {"viterbi_scan": 14, "ssv_scan": 3}


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
# K5 and K6's launch counters -> the warp kernel's entry point each calls
WARP_ENTRIES = {"descent_masked": "sp_descent_masked_warp",
                "descent_grid2d": "sp_descent_grid2d_warp"}


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


def time_ms_batched(fn, reps: int = 3, target_ms: float = 5.0) -> float:
    """Median milliseconds of one ``fn()`` on the card, each timing over
    back-to-back calls lasting about ``target_ms`` (1 to 20 calls), so the
    card, not the host's launch overhead, is timed where a call is short."""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    calls = max(1, min(20, int(target_ms / max(a.elapsed_time(b), 1e-3))))
    times = []
    for _ in range(reps):
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def device_ms(fn, x, kernel: str, calls: int = 20, required: bool = True) -> float | None:
    """Mean device milliseconds of one launch of the kernels whose name
    holds ``kernel``, over ``calls`` calls of ``fn(x)`` under torch.profiler:
    a warm-up step of ``calls`` calls, then the recorded step (a profiler
    run's first launches can go unrecorded). Raises if the recorded step
    saw more than ``calls`` launches of the kernel, or none and
    ``required``; None when it saw none (late in a long process the
    profiler has recorded no launch of a kernel at all)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    fn(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _step in range(2):
            for _ in range(calls):
                fn(x)
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.key_averages() if kernel in e.key and e.device_time_total > 0]
    launches = sum(e.count for e in events)
    if launches == 0 and not required:
        log(f"the profiler recorded no launch of {kernel}")
        return None
    if not 1 <= launches <= calls:
        raise RuntimeError(f"the profiler saw {launches} launches of {kernel} in {calls} calls")
    return sum(e.device_time_total for e in events) / launches / 1e3


def queued_ms(launch, calls: int = 20, reps: int = 3) -> float:
    """Device milliseconds of one bare kernel launch (``launch()`` calls a
    kernel's C entry and waits on nothing): ``calls`` launches queued
    behind a spin of the card, between two CUDA events, so the card runs
    them back to back and the span holds the kernels and the gaps between
    them, not the host's launch time; the median of ``reps``. Raises if the
    host took longer to queue them than the spin lasted."""
    import torch

    spin = 10_000_000  # clock cycles, ~5 ms
    launch()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(spin)
    b.record()
    torch.cuda.synchronize()
    spin_ms = a.elapsed_time(b)
    times = []
    for _ in range(reps):
        torch.cuda._sleep(spin)
        t0 = time.perf_counter()
        a.record()
        for _ in range(calls):
            launch()
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host_ms > 0.8 * spin_ms:
            raise RuntimeError(f"queuing {calls} launches took {host_ms} ms, the spin {spin_ms}")
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def bare_launch(entry: str, *args):
    """A call of the tree kernels' C entry ``entry`` on the current stream
    (tensors as pointers), raising on a launch error: what the wrapper
    launches, without its checks and allocations."""
    import torch

    from subphaser_torch.ltr import msa

    lib = msa.tree_counts_lib()
    fn = getattr(lib, entry)
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if fn(*cargs, stream) != 0:
            raise RuntimeError(f"{entry} launch failed")
    launch.tensors = args  # the pointers' tensors live as long as the launch
    return launch


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


def load_tool(name: str = "bench_sort_primitives_torch"):
    """A tool of tools/ as a module (tools/ is not a package): by default
    the sort-primitives tool."""
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_runs() -> dict:
    """The run-length kernel of ops/count (csrc/runs.cu) at the counting
    paths' shapes, by tools/bench_runs_torch.py: {shape: row}."""
    tool = load_tool("bench_runs_torch")
    rows = {}
    for name in tool.SHAPES:
        rows[name] = tool.run_shape(name)
        log(f"runs {name} " + json.dumps(rows[name]))
    log("phase runs ok: bit-exact against the plain version and the cummax chain at "
        + ", ".join(rows))
    return rows


def card_int32_ops_per_s() -> tuple[float, dict]:
    """The card's peak rate of 32-bit integer min/max/add:
    INT32_OPS_PER_CLOCK_PER_SM x SMs x the maximum SM clock nvidia-smi reads."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6, {"sm_clock_mhz": mhz, "sms": sms}


SORT_PHASES = {"block_sort": 13, "block_sort_unrolled": 18}  # log2 of the block each sorts


def primitive_ops(name: str, n: int) -> int:
    """32-bit integer operations a primitive's function needs on n keys: a
    compare-exchange stage is a min and a max per pair (n), max(x, x - 1) two
    per key. The block sorts' function is only "each block sorted", which a
    comparison sort does in about log2(block) comparisons a key, so they count
    n * log2(block), not their bitonic network (network_ops below)."""
    from subphaser_torch.ops import sort_primitives as sp

    if name in sp.STAGE_BITS:
        return len(sp.STAGE_BITS[name]) * n
    if name in SORT_PHASES:
        return min(n.bit_length() - 1, SORT_PHASES[name]) * n
    return {"elementwise30": 2 * sp.ELEMENTWISE_ITERS * n,
            "transpose8": 2 * sp.TRANSPOSE_REPS * n,
            "descent18_masked": len(sp.MASKED_BITS) * n,
            "descent18_grid2d": len(sp.GRID2D_BITS) * sp.GRID2D_REVISITS * n}[name]


def network_ops(name: str, n: int) -> int:
    """The min/max a block sort's bitonic network does on n keys: p(p + 1)/2
    stages of a min and a max per pair over p phases. Shown beside the
    bound, never as it: it is more work than the function needs."""
    p = min(n.bit_length() - 1, SORT_PHASES[name])
    return p * (p + 1) // 2 * n


def full_range_keys(n: int, seed: int):
    """Any int32, INT32_MIN sown every 1001 keys."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=gen, device="cuda",
                      dtype=torch.int64).to(torch.int32)
    x[::1001] = -(1 << 31)
    return x


def phase_primitives() -> tuple[dict, dict]:
    """Returns ({candidate: row}, {launch counter: launches of the tool's run});
    the whole bitonic sort's counter is among them as ``bitonic_sort``, the
    cluster kernel's entry points as ``sp_block_sort_cluster`` and
    ``sp_run_stages_cluster``."""
    import torch

    from subphaser_torch.ops import sort_primitives as sp
    from subphaser_torch.ops import sort_smem

    tool = load_tool()
    ops_per_s, clock = card_int32_ops_per_s()
    fits = {f"{max(n >> sp.CTA_BITS, 1)} CTAs": sp.clusters_that_fit(n)
            for n in (1 << 15, 1 << 16, 1 << 17, 1 << 25)}
    log(f"primitives clusters that fit at once {json.dumps(fits)}; {json.dumps(clock)}")
    for name in sp.launches:
        sp.launches[name] = 0
    sp.entry_launches.clear()
    sort_smem.bitonic_launches = 0
    tool_rows = tool.main([])
    launches = dict(sp.launches, bitonic_sort=sort_smem.bitonic_launches)
    cluster_entries = {e: sp.entry_launches.get(e, 0)
                       for e in ("sp_block_sort_cluster", "sp_run_stages_cluster")}
    warp_entries = {e: sp.entry_launches.get(e, 0) for e in WARP_ENTRIES.values()}
    idle = [name for name, count in {**launches, **cluster_entries, **warp_entries}.items()
            if count <= 0]
    if idle:
        raise RuntimeError(f"the tool's run launched no kernel of {idle}")
    # K3 one cluster launch a call; the six stage-list bodies on the cluster kernel
    n_lists = sum(1 for c in sp.BLOCK_MAP_CANDIDATES if c in sp.STAGE_BITS)
    if (cluster_entries["sp_block_sort_cluster"] != launches["block_sort_unrolled"]
            or cluster_entries["sp_run_stages_cluster"] * len(sp.BLOCK_MAP_CANDIDATES)
            != launches["block_map"] * n_lists):
        raise RuntimeError(f"K3/K4 did not all take the cluster kernel: {sp.entry_launches}")
    if any(launches[c] != warp_entries[e] for c, e in WARP_ENTRIES.items()):
        raise RuntimeError(f"K5/K6 did not all take the warp kernel: {sp.entry_launches}")
    launches.update(cluster_entries, **warp_entries)

    x_tool = tool.make_input(tool.N_BLOCKS, torch.device("cuda")) ^ 1
    n = x_tool.numel()
    x_full = full_range_keys(n, 7)
    plains = sp.plain_versions()
    bytes_ms = 8 * n / HBM_BYTES_PER_S * 1e3
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
        ops_ms = primitive_ops(name, n) / ops_per_s * 1e3
        rows[name] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: fn(x_tool)),
            "plain_ms": time_ms(lambda: plains[name](x_tool), 3),
            "bytes_bound_ms": bytes_ms,
            "ops_bound_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes",
            "tool_ms": tool_rows[name]["ms"],
        }
        if name in SORT_PHASES:
            rows[name]["network_ops_ms"] = network_ops(name, n) / ops_per_s * 1e3
        if name == "block_sort_unrolled":  # its library call, on the same input
            if not torch.equal(tool.segmented_sort(x_tool), fn(x_tool)):
                raise RuntimeError("the segmented torch.sort disagrees with K3")
            rows[name]["library_ms"] = time_ms(lambda: tool.segmented_sort(x_tool))
        log(f"primitive {name} " + json.dumps(rows[name]))
    for name in ("bitonic_sort", "radix_sort", "torch_sort", "torch_sort_segmented"):
        log(f"primitive {name} tool_ms={tool_rows[name]['ms']}")
    # K3 at every launch shape (one CTA padded, one CTA, clusters of 2,
    # one and several clusters of 8), and its library call, bit-exact
    k3 = rows["block_sort_unrolled"]
    k3["by_size"] = {}
    for bits in (10, 15, 16, 18, 19, 25):
        x = full_range_keys(1 << bits, bits)
        want = sort_smem.block_sort_plain(x, sp.BLOCK_BITS)
        before = sp.entry_launches.get("sp_block_sort_cluster", 0)
        got, lib = sp.block_sort_unrolled(x), tool.segmented_sort(x)
        torch.cuda.synchronize()
        if sp.entry_launches["sp_block_sort_cluster"] != before + 1:
            raise RuntimeError("block_sort_unrolled took more or less than one cluster launch")
        if not (torch.equal(got, want) and torch.equal(lib, want)):
            raise RuntimeError(f"K3 or its library call disagrees at n=2^{bits}")
        k3["by_size"][f"2^{bits}"] = {
            "max_abs_err": max(int((got.long() - want.long()).abs().max()),
                               int((lib.long() - want.long()).abs().max()))}
        if bits == 25:
            k3["by_size"]["2^25"].update(ms=time_ms(lambda: sp.block_sort_unrolled(x)),
                                         library_ms=time_ms(lambda: tool.segmented_sort(x)))
        del x, want, got, lib
    k3["clusters_that_fit"] = fits
    log("primitive block_sort_unrolled by size " + json.dumps(k3["by_size"]))
    if torch.equal(sp.block_sort_unrolled(x_full), sort_smem.block_sort(x_full)):
        raise RuntimeError("block_sort_unrolled ran the 2^13-key block sort, not K3's 2^18")
    check_warp_kernels(tool, rows, x_tool, x_full)
    halves = x_tool.view(tool.N_BLOCKS, 2, -1)
    bitonic = torch.cat([halves[:, 0].sort(dim=1).values,
                         halves[:, 1].sort(dim=1, descending=True).values], dim=1)
    got = sp.block_map("descent18", bitonic.reshape(-1)).view(tool.N_BLOCKS, -1)
    if not torch.equal(got, bitonic.sort(dim=1).values):
        raise RuntimeError("descent18 of a bitonic block disagrees with torch.sort")
    del x_tool, x_full, halves, bitonic, got
    torch.cuda.empty_cache()
    log(f"phase primitives ok: {len(rows)} candidates bit-exact at n = {n}, K3 and its "
        f"library call at n = 2^10..2^25; tool launches {json.dumps(launches)}")
    return rows, launches


def check_warp_kernels(tool, rows: dict, x_tool, x_full) -> None:
    """K5 and K6: bit-exact at one block, 3 blocks and the tool's size, on
    the tool's keys and on full-range keys, each call one launch of the warp
    kernel; their device time and share of the bound; K5 on 512-key bitonic
    groups against a per-group torch.sort (ascending where index bit 9 is
    clear, descending where it is set)."""
    import torch

    from subphaser_torch.ops import sort_primitives as sp

    plains = sp.plain_versions()
    for counter, entry in WARP_ENTRIES.items():
        name = PRIMITIVE_KERNELS[counter][2][0]
        fn, row = sp.candidates()[name], rows[name]
        row["by_size"] = {}
        for blocks in (1, 3, tool.N_BLOCKS):
            inputs = ((x_tool, x_full) if blocks == tool.N_BLOCKS else
                      (tool.make_input(blocks, torch.device("cuda")) ^ 1,
                       full_range_keys(blocks * sp.BLOCK, blocks)))
            err = 0
            for x in inputs:
                before = sp.entry_launches.get(entry, 0)
                got, want = fn(x), plains[name](x)
                torch.cuda.synchronize()
                if sp.entry_launches.get(entry, 0) != before + 1:
                    raise RuntimeError(f"{name} took more or less than one launch of {entry}")
                if not torch.equal(got, want):
                    raise RuntimeError(f"{name} disagrees with its plain version at {blocks} blocks")
                err = max(err, int((got.long() - want.long()).abs().max()))
            row["by_size"][f"{blocks} blocks"] = {"max_abs_err": err}
        row["device_ms"] = device_ms(fn, x_tool, "warp_stages")
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        log(f"primitive {name} by size {json.dumps(row['by_size'])}; device_ms "
            f"{row['device_ms']}, share_of_bound {row['share_of_bound']}")
    groups = x_tool.view(-1, 2, 256)
    bitonic = torch.cat([groups[:, 0].sort(dim=1).values,
                         groups[:, 1].sort(dim=1, descending=True).values], dim=1)
    want = bitonic.sort(dim=1).values
    want[1::2] = want[1::2].flip(1)  # bit 9 of the index: every other group
    if not torch.equal(sp.descent_masked(bitonic.reshape(-1)).view(-1, 512), want):
        raise RuntimeError("K5 of 512-key bitonic groups disagrees with torch.sort")


def gen_genome(out: str, n_sets: int, chrom_mb: float) -> tuple[str, str, str]:
    """tools/gen_wheat_scale.py OUT n_sets chrom_mb --hmm, once per directory:
    (FASTA, config, its fixture profile database)."""
    fa = os.path.join(out, f"genome14_1_{n_sets}.fa")
    cfg = os.path.join(out, "sg14.config")
    hmm = os.path.join(out, "wheat_rexdb.hmm")
    if not all(os.path.exists(p) for p in (fa, cfg, hmm)):
        os.makedirs(out, exist_ok=True)
        # the database's transitions are seeded from hash(profile name):
        # a fixed hash seed makes them, and so the LTR step's counts, the
        # same in every run
        subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "gen_wheat_scale.py"),
             out, str(n_sets), str(chrom_mb), "--hmm"],
            check=True, stdout=subprocess.DEVNULL, env=dict(os.environ, PYTHONHASHSEED="0"),
        )
    return fa, cfg, hmm


def run_cli(fa: str, cfg: str, out: str, *extra: str, ltr: list[str] | None = None,
            blocks: bool = False):
    """The port's CLI; the whole LTR step runs with the options ``ltr``
    (e.g. ["-hmm_db", path], or [] for none), and -disable_ltr when None;
    homoeologous blocks and circos run only with ``blocks``."""
    from subphaser_torch import cli

    ltr = ["-disable_ltr"] if ltr is None else ltr
    steps = [] if blocks else ["-disable_circos", "-disable_blocks"]
    return cli.main(["-i", fa, "-c", cfg, "-o", os.path.join(out, "out"),
                     "-tmpdir", os.path.join(out, "tmp"), *ltr, *steps, *extra])


def reset_anchor_launches() -> None:
    from subphaser_torch.ops import anchors

    for counts in (anchors.launches, anchors.entry_launches):
        for name in counts:
            counts[name] = 0


def anchor_launches() -> dict[str, int]:
    from subphaser_torch.ops import anchors

    return dict(anchors.launches)


def block_pafs(tmpdir: str) -> dict[str, str]:
    """{file name: path} of a run's tmp/Blocks/*.paf."""
    import glob

    return {os.path.basename(p): p
            for p in sorted(glob.glob(os.path.join(tmpdir, "Blocks", "*.paf")))}


def device_busy(trace_dir: str) -> dict:
    """Per step of a -trace run: its wall seconds and the seconds the card
    ran kernels inside its window (the step's end mark and its length, on
    the trace's clock), summed over the step's marks."""
    import glob

    (path,) = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise RuntimeError("the trace holds no kernel")
    steps: dict[str, dict] = {}
    for e in events:
        name = e.get("name", "")
        if not name.startswith("subphaser step "):
            continue
        _s, _t, step, seconds = name.split(" ")
        end = e["ts"] + e.get("dur", 0)
        start = end - float(seconds) * 1e6
        busy = sum(max(0.0, min(b, end) - max(a, start)) for a, b in kernels) / 1e6
        row = steps.setdefault(step, {"wall_s": 0.0, "device_busy_s": 0.0})
        row["wall_s"] += float(seconds)
        row["device_busy_s"] += busy
    return {"steps": steps, "kernels": len(kernels),
            "kernel_s": sum(b - a for a, b in kernels) / 1e6,
            "trace_mb": os.path.getsize(path) / 2**20}


def tree_files(pipe) -> dict[str, list[str]]:
    """{group: the tree-file suffixes it wrote} in a run's output."""
    prefix = os.path.basename(pipe.para_prefix) + "."
    groups: dict[str, list[str]] = {}
    for name in sorted(os.listdir(os.path.dirname(pipe.para_prefix))):
        for suffix in TREE_SUFFIXES:
            if name.startswith(prefix) and name.endswith(suffix):
                groups.setdefault(name[len(prefix):-len(suffix)], []).append(suffix)
    return groups


def reset_tree_launches() -> None:
    from subphaser_torch.ltr import msa, tree

    msa.launches["match_counts"] = 0
    msa.route_launches["match_counts"] = dict.fromkeys(msa.route_launches["match_counts"], 0)
    tree.launches["inter_counts"] = 0


def match_counts_routes() -> dict[str, int]:
    from subphaser_torch.ltr import msa

    return dict(msa.route_launches["match_counts"])


def tree_launches() -> dict[str, int]:
    from subphaser_torch.ltr import msa, tree

    return {"match_counts": msa.launches["match_counts"],
            "inter_counts": tree.launches["inter_counts"]}


def read_assignments(pipe_or_prefix) -> dict[str, tuple[str, int]]:
    """{chromosome: (SG, bootstrap)} of a run's .chrom-subgenome.tsv (a
    Pipeline, or its output prefix)."""
    prefix = getattr(pipe_or_prefix, "para_prefix", pipe_or_prefix)
    with open(prefix + ".chrom-subgenome.tsv") as f:
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


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_parity() -> dict:
    """Returns the LTR step's seconds on the card and on the CPU, and the
    tree kernels' launches of the card's runs, by route."""
    fa, cfg, hmm = gen_genome(os.path.join(WORK, "small"), 2, 2)
    small = os.path.join(WORK, "small")
    res = {"ltr_step_s": {}, "trees": {}, "launches": {}}
    # (run, k, LTR options): the domain route (-hmm_db), the sketch route
    # (no database: every LTR kept, no peptides) from k15's core checkpoints
    for run, k, ltr in (("k15", 15, ["-hmm_db", hmm]), ("k15_sketch", 15, []),
                        ("k17", 17, None)):
        args = ("-k", str(k), "-min_freq", "4", "-lower_count", "2",
                "-tile_bases", str(1 << 20), "-replicates", "100")
        runs = {}
        for dev in ("cuda", "cpu"):
            out = os.path.join(small, f"{dev}_{run}")
            if run == "k15_sketch":
                shutil.copytree(os.path.join(small, f"{dev}_k15", "tmp"), os.path.join(out, "tmp"),
                                ignore=shutil.ignore_patterns("LTR"))
            reset_tree_launches()
            runs[dev] = run_cli(fa, cfg, out, *args, "-device", dev, ltr=ltr)
            if ltr is not None:
                res["ltr_step_s"].setdefault(run, {})[dev] = {
                    s: round(v, 3) for s, v in runs[dev].step_seconds.items()
                    if s.startswith("ltr_")}
            if dev == "cuda" and ltr is not None:
                res["launches"][run] = tree_launches()
        gpu, cpu = runs["cuda"], runs["cpu"]
        suffixes = [s for s in CORE_FILES if s != ".chrom-subgenome.tsv"]
        for suffix in suffixes + (LTR_OUT_FILES if ltr is not None else []):
            if not same_bytes(gpu.para_prefix + suffix, cpu.para_prefix + suffix):
                raise RuntimeError(f"{run}: {suffix} differs between cuda and cpu runs")
        for name in LTR_TMP_FILES if ltr else []:
            paths = [os.path.join(small, f"{dev}_{run}", "tmp", "LTR", name)
                     for dev in ("cuda", "cpu")]
            if not same_bytes(*paths):
                raise RuntimeError(f"{run}: {name} differs between cuda and cpu runs")
        a_gpu, a_cpu = read_assignments(gpu), read_assignments(cpu)
        if {c: v[0] for c, v in a_gpu.items()} != {c: v[0] for c, v in a_cpu.items()}:
            raise RuntimeError(f"{run}: assignments differ: cuda {a_gpu} cpu {a_cpu}")
        check_phased(a_gpu)
        if ltr is None:
            continue
        if not (gpu.ltr_pipeline.n_candidates and gpu.enriched_ltrs):
            raise RuntimeError(f"12 Mb {run}: no LTR candidates or none enriched")
        groups = tree_files(gpu)
        if groups != tree_files(cpu):
            raise RuntimeError(f"{run}: tree files differ: cuda {groups} cpu {tree_files(cpu)}")
        for group, written in groups.items():
            for suffix in written:
                if not same_bytes(f"{gpu.para_prefix}.{group}{suffix}",
                                  f"{cpu.para_prefix}.{group}{suffix}"):
                    raise RuntimeError(f"{run}: {group}{suffix} differs between cuda and cpu")
        route = "alignment" if ltr else "sketch"
        trees = [g for g, w in groups.items() if ".tree.nwk" in w
                 and (".aln" in w) == (route == "alignment")]
        kernel = "match_counts" if route == "alignment" else "inter_counts"
        if not trees or res["launches"][run][kernel] <= 0:
            raise RuntimeError(f"{run}: no tree by the {route} route, or no {kernel} "
                               f"launch: {groups} {res['launches'][run]}")
        res["trees"][run] = {g: len(open(f"{gpu.para_prefix}.{g}.tree.map").readlines())
                             for g in trees}
    res["feature_map_device"] = parity_feature_map(fa, cfg, hmm)
    res.update(parity_default(fa, cfg, hmm))
    log(f"parity {json.dumps(res)}")
    log("phase parity ok: 12 Mb genome at k = 15 (LTR step with trees, the alignment and the "
        "sketch route) and k = 17, cuda == cpu on the five count/map/enrich files, the seven "
        "LTR files, every tree file and the assignments; the default run's "
        f"{len(res['pafs'])} PAFs cuda == cpu")
    return res


def parity_feature_map(fa: str, cfg: str, hmm: str) -> dict:
    """The LTR step's k-mer mapping by the device route
    (SUBPHASER_FEATURE_MAP=device: genome tiles of the features on the
    card) from the card's k = 15 run's checkpoints (detection and
    classification load; trees off): its LTR files must be byte-identical
    to that run's, which took the host route, and the host route must not
    run."""
    from subphaser_torch.phase import features

    small = os.path.join(WORK, "small")
    out = os.path.join(small, "cuda_k15_devmap")
    shutil.copytree(os.path.join(small, "cuda_k15", "tmp"), os.path.join(out, "tmp"))
    host_calls = []
    host_route = features.FeaturePack._map_counts_host

    def counted(self, *args, **kwargs):
        host_calls.append(1)
        return host_route(self, *args, **kwargs)

    features.FeaturePack._map_counts_host = counted
    os.environ["SUBPHASER_FEATURE_MAP"] = "device"
    try:
        pipe = run_cli(fa, cfg, out, "-k", "15", "-min_freq", "4", "-lower_count", "2",
                       "-tile_bases", str(1 << 20), "-replicates", "100", "-disable_ltrtree",
                       "-device", "cuda", ltr=["-hmm_db", hmm])
    finally:
        os.environ.pop("SUBPHASER_FEATURE_MAP")
        features.FeaturePack._map_counts_host = host_route
    if host_calls:
        raise RuntimeError(f"the device feature-mapping route took the host route "
                           f"{len(host_calls)} times")
    ref = os.path.join(small, "cuda_k15", "out", os.path.basename(pipe.para_prefix))
    for suffix in LTR_OUT_FILES:
        if not same_bytes(pipe.para_prefix + suffix, ref + suffix):
            raise RuntimeError(f"{suffix} differs between the device and host feature-map routes")
    return {"ltr_map_s": round(pipe.step_seconds["ltr_map"], 3),
            "enriched_ltrs": len(pipe.enriched_ltrs), "files": len(LTR_OUT_FILES)}


def parity_default(fa: str, cfg: str, hmm: str) -> dict:
    """The 12 Mb default run (blocks and circos) from the k = 15 run's
    checkpoints on the card and on the CPU, then traced on the card."""
    small = os.path.join(WORK, "small")
    args = ("-k", "15", "-min_freq", "4", "-lower_count", "2", "-tile_bases", str(1 << 20),
            "-replicates", "100", "-hmm_db", hmm)
    res = {"blocks_step_s": {}}
    pafs = {}
    for dev in ("cuda", "cpu"):
        out = os.path.join(small, f"{dev}_default")
        shutil.copytree(os.path.join(small, f"{dev}_k15", "tmp"), os.path.join(out, "tmp"))
        reset_anchor_launches()
        pipe = run_cli(fa, cfg, out, *args, "-device", dev, ltr=[], blocks=True)
        if dev == "cuda":
            res["anchor_launches"] = anchor_launches()
        res["blocks_step_s"][dev] = {s: round(pipe.step_seconds[s], 3) for s in BLOCK_STEPS
                                     if s in pipe.step_seconds}
        pafs[dev] = block_pafs(os.path.join(out, "tmp"))
    if list(pafs["cuda"]) != list(pafs["cpu"]) or len(pafs["cuda"]) != 6:
        raise RuntimeError(f"default run: PAF files differ: {pafs}")
    for name, path in pafs["cuda"].items():
        if not same_bytes(path, pafs["cpu"][name]):
            raise RuntimeError(f"default run: {name} differs between cuda and cpu")
    if min(res["anchor_launches"].values()) <= 0:
        raise RuntimeError(f"default run: an anchor kernel did not launch: "
                           f"{res['anchor_launches']}")
    res["pafs"] = {name: sum(1 for _ in open(path)) for name, path in pafs["cuda"].items()}
    out = os.path.join(small, "cuda_trace")
    shutil.copytree(os.path.join(small, "cuda_k15", "tmp"), os.path.join(out, "tmp"))
    t0 = time.perf_counter()
    pipe = run_cli(fa, cfg, out, *args, "-device", "cuda", "-trace", os.path.join(out, "trace"),
                   ltr=[], blocks=True)
    res["trace_run_wall_s"] = time.perf_counter() - t0
    res["device_busy"] = device_busy(os.path.join(out, "trace"))
    res["device_busy"]["step_s"] = {s: round(v, 3) for s, v in pipe.step_seconds.items()}
    return res


def synthetic_profiles(n: int, m: int, seed: int):
    """``n`` REXdb-named profiles of ``m`` nodes: random log-odds emissions
    and transitions with ~10% forbidden (-inf) moves."""
    import numpy as np

    from subphaser_torch.ltr.classify import Profile

    rng = np.random.default_rng(seed)
    profs = []
    for i in range(n):
        trans = {}
        for name in ("tmm", "tmi", "tmd", "tim", "tii", "tdm", "tdd"):
            t = -rng.exponential(2.0, size=m + 1)
            t[rng.random(m + 1) < 0.1] = -np.inf
            trans[name] = t
        profs.append(Profile(name=f"Class_I/LTR/Ty3_gypsy/synthetic{i}/RT", length=m,
                             match_scores=rng.normal(-1.0, 1.5, size=(m + 1, 20)), **trans))
    return profs


def hmm_rows(rows: int, length: int, best_row):
    """``rows`` residue rows of ``length`` (valid counts in [length/2,
    length], as a length bucket holds; one full row, one empty row, and the
    best-scoring peptide of the first profile planted in row 2)."""
    import numpy as np

    rng = np.random.default_rng(length)
    res = rng.integers(0, 20, size=(rows, length)).astype(np.int8)
    nv = rng.integers(length // 2, length + 1, size=rows).astype(np.int32)
    nv[0], nv[1] = length, 0
    k = min(best_row.shape[0], length)
    res[2, :k] = np.argmax(best_row[:k], axis=1)
    nv[2] = max(int(nv[2]), k)
    return res, nv


def phase_hmm() -> dict:
    """Returns {kernel: {"<stack> P=.. M=.. B=<rows> L=<length>": row}}."""
    import torch

    from subphaser_torch.ltr import classify as tc

    _fa, _cfg, db = gen_genome(os.path.join(WORK, "small"), 2, 2)
    rows = {"viterbi_scan": {}, "ssv_scan": {}}
    for stack_name, (n_prof, nodes, seed, shapes) in HMM_STACKS.items():
        profs = tc.load_hmm_db(db) if seed is None else synthetic_profiles(n_prof, nodes, seed)
        stack = tc.ProfileStack(profs, device="cuda")
        d = stack.dev
        p, m = stack.ms.shape[:2]
        route = tc.scan_route(m)[0]
        for n_rows, length in shapes:
            res_h, nv_h = hmm_rows(n_rows, length, stack.ms[0])
            res, nv = stack._rows(res_h, nv_h)
            vit = lambda: tc.viterbi_scan(res, nv, *(d[a] for a in tc.ProfileStack.ARRAYS))  # noqa: E731
            ssv = lambda: tc.ssv_scan(res, nv, d["ms"])  # noqa: E731
            by_route = {n: dict(r) for n, r in tc.route_launches.items()}
            got = {"viterbi_scan": vit(), "ssv_scan": (ssv(),)}
            torch.cuda.synchronize()
            if any(tc.route_launches[n][route] != by_route[n][route] + 1 for n in by_route):
                raise RuntimeError(f"{stack_name} M={m}: the scans did not take the {route} route")
            plain = {}
            t0 = time.perf_counter()
            plain["viterbi_scan"] = tc.viterbi_scan_plain(
                res, nv, *(d[a] for a in tc.ProfileStack.ARRAYS))
            torch.cuda.synchronize()
            plain_ms = {"viterbi_scan": (time.perf_counter() - t0) * 1e3}
            t0 = time.perf_counter()
            plain["ssv_scan"] = (tc.ssv_scan_plain(res, nv, d["ms"]),)
            torch.cuda.synchronize()
            plain_ms["ssv_scan"] = (time.perf_counter() - t0) * 1e3
            residues = int(nv_h.sum())
            key = f"{stack_name} P={p} M={m} B={n_rows} L={length}"
            for name, fn in (("viterbi_scan", vit), ("ssv_scan", ssv)):
                if not all(torch.equal(a, b) for a, b in zip(got[name], plain[name])):
                    raise RuntimeError(f"{name} disagrees with its plain version ({key})")
                cells = residues * p * (m + 1 if name == "viterbi_scan" else m)
                ops_ms = cells * HMM_OPS_PER_CELL[name] / FP32_OPS_PER_S * 1e3
                in_bytes = res.numel() + 4 * nv.numel() + sum(
                    d[a].numel() * 4 for a in (tc.ProfileStack.ARRAYS
                                               if name == "viterbi_scan" else ("ms",)))
                out_bytes = n_rows * p * (8 if name == "viterbi_scan" else 4)
                bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
                rows[name][key] = {
                    "route": route,
                    "max_abs_err": max(float((a.double() - b.double()).abs().max())
                                       for a, b in zip(got[name], plain[name])),
                    "ms": time_ms_batched(fn),
                    "plain_ms": plain_ms[name],
                    "bound_ms": max(ops_ms, bytes_ms),
                    "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                    "cells": cells,
                }
                if route == "warp":  # the block route on the same inputs, side by side
                    block = {"viterbi_scan": lambda: tc._viterbi_launch(  # noqa: E731
                        ("block", 0), res, nv, *(d[a] for a in tc.ProfileStack.ARRAYS)),
                        "ssv_scan": lambda: (tc._ssv_launch(("block", 0), res, nv, d["ms"]),)}[name]
                    if not all(torch.equal(a, b) for a, b in zip(block(), got[name])):
                        raise RuntimeError(f"{name}: the block route disagrees ({key})")
                    rows[name][key]["block_ms"] = time_ms_batched(block)
                log(f"hmm {name} {key} " + json.dumps(rows[name][key]))
            del got, plain, res, nv
        del stack, d
    torch.cuda.empty_cache()
    log(f"phase hmm ok: viterbi_scan and ssv_scan bit-exact against their plain versions "
        f"on {len(HMM_STACKS)} profile stacks, both routes")
    return rows


def phase_ltr() -> dict:
    """The LTR step on the 480 Mb genome, resumed from phase main's core
    checkpoints (a copy of its tmpdir)."""
    import torch

    from subphaser_torch.ltr import classify as tc

    fa, cfg, hmm = main_genome()
    src = os.path.join(WORK, "main", "tmp")
    work = os.path.join(WORK, "ltr")
    if not os.path.isdir(src):
        raise RuntimeError("phase ltr needs phase main's tmpdir")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, os.path.join(work, "tmp"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in tc.launches:
        tc.launches[name] = 0
        tc.route_launches[name] = dict.fromkeys(tc.route_launches[name], 0)
    # per scan and length bucket: launches, rows and the span between CUDA
    # events around each wrapper call (ProfileStack calls the module's
    # functions by name): an upper bound on the scans' device time, as the
    # span also holds the wrapper's host work
    buckets = {"viterbi_scan": {}, "ssv_scan": {}}
    originals = {name: getattr(tc, name) for name in buckets}

    def timed(name):
        def call(res, *args, **kwargs):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = originals[name](res, *args, **kwargs)
            b.record()
            buckets[name].setdefault(res.shape[1], []).append((res.shape[0], a, b))
            return out
        return call

    for name in buckets:
        setattr(tc, name, timed(name))
    reset_tree_launches()
    t0 = time.perf_counter()
    try:
        pipe = run_cli(fa, cfg, work, "-k", "15", "-min_freq", "200", ltr=["-hmm_db", hmm])
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(tc, name, fn)
    wall = time.perf_counter() - t0
    launches = dict(tc.launches)
    by_route = {name: dict(r) for name, r in tc.route_launches.items()}
    by_bucket = {name: {f"L={length}": {
        "launches": len(calls), "rows": sum(n for n, _a, _b in calls),
        "span_ms": sum(a.elapsed_time(b) for _n, a, b in calls)}
        for length, calls in sorted(per.items())} for name, per in buckets.items()}
    lp = pipe.ltr_pipeline
    for suffix in LTR_OUT_FILES:
        if not os.path.getsize(pipe.para_prefix + suffix):
            raise RuntimeError(f"empty output {suffix}")
    if not lp.n_candidates or not lp.n_ltr_order or not pipe.enriched_ltrs:
        raise RuntimeError(f"LTR step: {lp.n_candidates} candidates, {lp.n_ltr_order} "
                           f"classified LTR, {len(pipe.enriched_ltrs)} enriched")
    idle = [name for name, count in launches.items() if count <= 0]
    if idle:
        raise RuntimeError(f"the ltr path launched no {idle}")
    if any(r["warp"] != launches[name] for name, r in by_route.items()):
        raise RuntimeError(f"the ltr path's scans did not all take the warp route: {by_route}")
    launches.update(tree_launches())  # inter_counts: the sketch route, none here
    by_route["match_counts"] = match_counts_routes()
    if by_route["match_counts"]["bits"] != launches["match_counts"]:
        raise RuntimeError(f"the ltr path's match_counts did not all take the bits route: "
                           f"{by_route['match_counts']} of {launches['match_counts']}")
    trees = check_trees(pipe, launches)
    LTR_RUN["pipe"] = pipe  # phase trees works on this run's data
    result = {
        "genome_mbp": pipe.genome.total_bases() / 1e6,
        "wall_s": round(wall, 3),
        "step_s": {s: round(pipe.step_seconds[s], 3) for s in LTR_STEPS},
        "other_step_s": {s: round(v, 3) for s, v in pipe.step_seconds.items()
                         if s not in LTR_STEPS},
        "candidates": lp.n_candidates,
        "ltr_order": lp.n_ltr_order,
        "ltr_order_share": lp.n_ltr_order / lp.n_candidates,
        "enriched_ltrs": len(pipe.enriched_ltrs),
        "launches": launches,
        "launches_by_route": by_route,
        "scans_by_bucket": by_bucket,
        "scans_span_s": {name: sum(r["span_ms"] for r in per.values()) / 1e3
                           for name, per in by_bucket.items()},
        "pass1_jobs": dict(tc.PASS1_STATS),
        "trees": trees,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    log("ltr " + json.dumps(result))
    log(f"phase ltr ok: {result['candidates']} candidates, {result['ltr_order']} LTR order, "
        f"{result['enriched_ltrs']} SG-enriched, trees {json.dumps(trees['groups'])} in "
        f"{result['step_s']['ltr_tree']} s, launches {json.dumps(launches)}")
    return result


LTR_RUN: dict = {}


def read_alignment(path: str):
    """An aligned FASTA (.aln / .trimal) -> (n, L) uint8 residue indices
    (the port's alphabet, '-' = GAP)."""
    import numpy as np

    from subphaser_torch.ltr import msa

    code = np.full(256, 255, np.uint8)
    for i, a in enumerate(msa.AA + "-"):
        code[ord(a)] = i
    with open(path) as f:
        rows = [line.strip() for line in f if not line.startswith(">")]
    aln = code[np.frombuffer("".join(rows).encode(), np.uint8)].reshape(len(rows), -1)
    if (aln == 255).any():
        raise RuntimeError(f"{path}: letters outside the alignment alphabet")
    return aln


def check_trees(pipe, launches: dict) -> dict:
    """Every superfamily group of >= 4 enriched LTRs has a .tree.nwk and a
    .tree.map; match_counts launched tree_boot + 1 times for each group of
    the alignment route. Returns per group its leaves, route, and aligned
    and trimmed columns."""
    from collections import Counter

    sizes = Counter(ltr.superfamily or "LTR" for ltr in pipe.enriched_ltrs
                    if not (pipe.exclude_exchanges and ltr.exchange == "yes"))
    written = tree_files(pipe)
    missing = [g for g, c in sizes.items() if c >= 4
               and not {".tree.nwk", ".tree.map"} <= set(written.get(g, []))]
    if missing:
        raise RuntimeError(f"no tree for the groups {missing} ({dict(sizes)}, {written})")
    groups = {}
    for group, suffixes in written.items():
        with open(f"{pipe.para_prefix}.{group}.tree.map") as f:
            row = {"members": sizes[group], "leaves": sum(1 for _ in f)}
        if ".aln" in suffixes:
            aln = read_alignment(f"{pipe.para_prefix}.{group}.aln")
            trimmed = read_alignment(f"{pipe.para_prefix}.{group}.trimal")
            row.update(route="alignment", n=aln.shape[0], aligned_L=aln.shape[1],
                       trimmed_L=trimmed.shape[1])
        else:
            row["route"] = "sketch"
        groups[group] = row
    n_aln = sum(r["route"] == "alignment" for r in groups.values())
    if launches["match_counts"] != (pipe.tree_boot + 1) * n_aln:
        raise RuntimeError(f"match_counts launched {launches['match_counts']} times for "
                           f"{n_aln} alignment groups at tree_boot {pipe.tree_boot}")
    if n_aln == 0:
        raise RuntimeError(f"no tree took the alignment route: {groups}")
    return {"groups": groups, "tree_boot": pipe.tree_boot}


def one_hot_stack(aln, w):
    """The JAX function's operands: (21, n, L) float32 one-hot rows (slots
    0..19 the residues, 20 = not a gap) and the same times the weights."""
    import torch

    from subphaser_torch.ltr import msa

    codes = torch.arange(21, device=aln.device, dtype=torch.uint8)[:, None, None]
    oh = (aln[None] == codes).to(torch.float32)
    oh[msa.GAP] = (aln != msa.GAP).to(torch.float32)
    return oh, oh * w


def random_alignment(n: int, length: int, seed: int):
    """(n, L) uint8 residues and gaps (gap-rich rows, an all-gap row and
    column)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 21, size=(n, length)).astype(np.uint8)
    a[: n // 3, : length // 2] = 20
    if n > 2:
        a[n // 2] = 20
    if length > 2:
        a[:, length // 2] = 20
    return a


def tree_weight_sets(length: int, seed: int = 0) -> dict:
    """Ones, and the first bootstrap replicate's multinomial column counts
    (nj_with_support's draw)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"ones": np.ones(length, np.float32),
            "multinomial": rng.multinomial(length, np.full(length, 1.0 / length))
            .astype(np.float32)}


def popc_per_s() -> float:
    """The card's 32-bit population counts a second: POPC_PER_CLOCK_PER_SM
    x SMs x the maximum SM clock nvidia-smi reads."""
    clock = card_int32_ops_per_s()[1]
    return POPC_PER_CLOCK_PER_SM * clock["sms"] * clock["sm_clock_mhz"] * 1e6


def match_counts_bits_launch(a, w_h, V, M):
    """A bare launch of the bits route's C entry (tc_match_counts_bits:
    pack_planes_kernel, then bit_counts_kernel) on the expansion of
    ``w_h``, with its own index and scratch."""
    import torch

    from subphaser_torch.ltr import msa

    n, length = a.shape
    idx = torch.from_numpy(msa.expansion_index(w_h)).cuda()
    planes = torch.empty(n * -(-idx.numel() // 32) * msa.PLANES, dtype=torch.int32,
                         device="cuda")
    return bare_launch("tc_match_counts_bits", a, n, length, idx, idx.numel(), planes, V, M)


def check_match_counts(aln_h, w_h, timed: bool) -> dict:
    """match_counts on the card against its plain version and the library
    call (equal, exact), which integer weights send by the bits route; with
    ``timed``, the times of the bits route and of the float route (the
    bare C entries on the same inputs) and both routes' bounds."""
    import torch

    from subphaser_torch.ltr import msa

    n, length = aln_h.shape
    if msa.match_counts_route(w_h) != "bits":
        raise RuntimeError("integer weights that match_counts would not send by the bits route")
    a, w = torch.from_numpy(aln_h).cuda(), torch.from_numpy(w_h).cuda()
    before, by_route = msa.launches["match_counts"], match_counts_routes()
    (v, m), (pv, pm) = msa.match_counts(a, w), msa.match_counts_plain(a, w)
    oh, ohw = one_hot_stack(a, w)
    lib = torch.matmul(ohw, oh.transpose(1, 2))
    torch.cuda.synchronize()
    if (msa.launches["match_counts"] != before + 1
            or match_counts_routes() != dict(by_route, bits=by_route["bits"] + 1)):
        raise RuntimeError("match_counts took more or less than one launch of the bits route")
    if not (torch.equal(v, pv) and torch.equal(m, pm)):
        raise RuntimeError(f"match_counts disagrees with its plain version at n={n} L={length}")
    if not (torch.equal(lib[msa.GAP], v) and torch.equal(lib[: msa.GAP].sum(0), m)):
        raise RuntimeError(f"the one-hot matmul disagrees with match_counts at n={n} L={length}")
    row = {"n": n, "L": length, "route": "bits",
           "max_abs_err": max(float((v - pv).abs().max()), float((m - pm).abs().max()))}
    if timed:
        # bytes: the alignment, the weights and the two outputs, once;
        # popcounts: two (V, M) a pair and 32-column word of the expanded
        # columns, over the n(n + 1)/2 unordered pairs; the float route's
        # bound, which its design defines: two float32 adds a pair and
        # weighted column
        pairs = n * (n + 1) // 2
        cols, expanded = int((w != 0).sum()), int(w_h.sum())
        bytes_bound = (n * length + 4 * length + 8 * n * n) / HBM_BYTES_PER_S * 1e3
        popc_bound = 2 * pairs * -(-expanded // 32) / popc_per_s() * 1e3
        float_bound = pairs * cols * 2 / FP32_OPS_PER_S * 1e3
        V, M = torch.empty_like(v), torch.empty_like(m)
        bits = match_counts_bits_launch(a, w_h, V, M)
        flt = bare_launch("tc_match_counts", a, w, n, length, V, M)
        pack = device_ms(lambda _x: bits(), None, "pack_planes_kernel", required=False)
        count = device_ms(lambda _x: bits(), None, "bit_counts_kernel", required=False)
        row.update(
            ms=time_ms(lambda: msa.match_counts(a, w)),
            device_ms=queued_ms(bits),
            profiler_ms=None if pack is None or count is None else pack + count,
            profiler_split_ms={"pack_planes_kernel": pack, "bit_counts_kernel": count},
            plain_ms=time_ms(lambda: msa.match_counts_plain(a, w), 3),
            library_ms=time_ms(lambda: torch.matmul(ohw, oh.transpose(1, 2))),
            bound_ms=max(bytes_bound, popc_bound),
            bound_by="operations" if popc_bound >= bytes_bound else "bytes",
            bytes_bound_ms=bytes_bound, popcount_bound_ms=popc_bound,
            float_route={"device_ms": queued_ms(flt),
                         "profiler_ms": device_ms(lambda _x: flt(), None, "match_counts_kernel",
                                                  required=False),
                         "bound_ms": float_bound, "bound_by": "operations"},
            weighted_columns=cols, expanded_columns=expanded)
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        row["float_route"]["share_of_bound"] = float_bound / row["float_route"]["device_ms"]
    return row


def fractional(w_h):
    """Non-integer weights from integer ones: 0.7 w + 0.1, float32."""
    import numpy as np

    return (w_h * np.float32(0.7) + np.float32(0.1)).astype(np.float32)


def check_match_counts_float(aln_h, w_h) -> dict:
    """match_counts with non-integer weights (the float route) against its
    plain version. Tolerance: 2 L 2^-24 sum(w), twice the worst-case error
    of a float32 sum of L non-negative terms, as the kernel's adds and the
    one-hot matmuls sum the same terms in other orders."""
    import torch

    from subphaser_torch.ltr import msa

    n, length = aln_h.shape
    if msa.match_counts_route(w_h) != "float":
        raise RuntimeError("weights that match_counts would not send by the float route")
    a, w = torch.from_numpy(aln_h).cuda(), torch.from_numpy(w_h).cuda()
    by_route = match_counts_routes()
    (v, m), (pv, pm) = msa.match_counts(a, w), msa.match_counts_plain(a, w)
    torch.cuda.synchronize()
    if match_counts_routes() != dict(by_route, float=by_route["float"] + 1):
        raise RuntimeError("match_counts took more or less than one launch of the float route")
    err = max(float((v - pv).abs().max()), float((m - pm).abs().max()))
    tol = 2 * length * 2.0 ** -24 * float(w_h.astype("float64").sum())
    if err > tol:
        raise RuntimeError(f"match_counts' float route is {err} from its plain version, "
                           f"above {tol}, at n={n} L={length}")
    return {"n": n, "L": length, "route": "float", "max_abs_err": err, "tolerance": tol,
            "ms": time_ms(lambda: msa.match_counts(a, w)),
            "plain_ms": time_ms(lambda: msa.match_counts_plain(a, w), 3)}


def check_inter_counts(pad_h, sizes, timed: bool) -> dict:
    """inter_counts on the card against its plain version over every pair
    of the rows of ``pad_h``, in mash_distances' chunks (exact); with
    ``timed``, one chunk's times and bound."""
    import numpy as np
    import torch

    from subphaser_torch import kernels
    from subphaser_torch.ltr import tree

    n, s = pad_h.shape
    pad = torch.from_numpy(pad_h).cuda()
    ai, bi = (torch.from_numpy(x).cuda() for x in np.triu_indices(n, 1))
    err = 0
    for lo in range(0, ai.numel(), tree.PAIR_CHUNK):
        a, b = ai[lo:lo + tree.PAIR_CHUNK], bi[lo:lo + tree.PAIR_CHUNK]
        before = tree.launches["inter_counts"]
        got = tree.inter_counts(pad, a, b, checked=True)
        want = tree.inter_counts_plain(pad, a, b)
        torch.cuda.synchronize()
        if tree.launches["inter_counts"] != before + 1 or not torch.equal(got, want):
            raise RuntimeError(f"inter_counts disagrees with its plain version at n={n} s={s}")
        err = max(err, int((got.long() - want.long()).abs().max()))
    row = {"n": n, "s": s, "pairs": int(ai.numel()), "max_abs_err": err}
    if timed:
        a, b = ai[:tree.PAIR_CHUNK], bi[:tree.PAIR_CHUNK]
        # one call of the path's shape (a chunk of pairs): a merge of two
        # sorted sketches needs a compare a value of either (their real
        # sizes); bytes: the sketches, the pair lists and the counts, once
        ops_ms = float((sizes[a.cpu().numpy()].astype(np.int64)
                        + sizes[b.cpu().numpy()]).sum()) / card_int32_ops_per_s()[0] * 1e3
        bytes_ms = (pad_h.nbytes + 20 * a.numel()) / HBM_BYTES_PER_S * 1e3
        out = torch.empty(a.numel(), dtype=torch.int32, device="cuda")
        row.update(
            timed_pairs=int(a.numel()),
            # the path's call (mash_distances' indices, checked on the host),
            # and a call whose index check reads back from the card
            ms=time_ms(lambda: tree.inter_counts(pad, a, b, checked=True)),
            ms_index_check_on_card=time_ms(lambda: tree.inter_counts(pad, a, b)),
            kernel_launches_a_call=kernels.graph_kernel_launches(
                lambda: tree.inter_counts(pad, a, b, checked=True)),
            device_ms=queued_ms(bare_launch("tc_inter_counts", pad, s, a, b, a.numel(), out)),
            profiler_ms=device_ms(lambda _x: tree.inter_counts(pad, a, b, checked=True), None,
                                  "inter_counts_kernel", required=False),
            plain_ms=time_ms(lambda: tree.inter_counts_plain(pad, a, b), 3),
            library_ms=None,
            bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        if row["kernel_launches_a_call"] != 1:
            raise RuntimeError(f"inter_counts launched {row['kernel_launches_a_call']} kernels "
                               f"a call, not 1")
    return row


def mash_waits(sketches) -> dict:
    """mash_distances on the card at the sketches' size (after a warm-up
    call): its wall seconds alone; its inter_counts launches' device time
    by CUDA events around each launch; then under torch.profiler its device
    time (every device event: kernels, copies, fills; None where the
    profiler recorded none) with inter_counts' part, and its host waits:
    the synchronising calls (stream, device and event synchronize) and the
    host-device copies, with their host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from subphaser_torch.ltr import msa, tree

    tree.mash_distances(sketches, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree.mash_distances(sketches, device="cuda")
    wall = time.perf_counter() - t0
    # CUDA events around each launch of the C entry (its span also holds the
    # launch's own latency: an upper bound of the kernels' device time)
    lib = msa.tree_counts_lib()
    entry, spans = lib.tc_inter_counts, []

    def timed(*args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        err = entry(*args)
        b.record()
        spans.append((a, b))
        return err
    lib.tc_inter_counts = timed
    try:
        tree.mash_distances(sketches, device="cuda")
    finally:
        lib.tc_inter_counts = entry
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tree.mash_distances(sketches, device="cuda")
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    syncs = [e for e in events if e.device_type == DeviceType.CPU and e.name in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")]
    copies = [e for e in events if e.device_type == DeviceType.CPU
              and e.name.startswith("cudaMemcpy")]
    if not dev:
        log("the profiler recorded no device event of mash_distances")
    return {"sketches": len(sketches), "wall_s": round(wall, 4),
            "inter_counts_launches_by_events": len(spans),
            "inter_counts_event_ms": sum(a.elapsed_time(b) for a, b in spans),
            "card_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3 if dev else None,
            "inter_counts_kernel_ms": sum(e.time_range.elapsed_us() for e in dev
                                          if "inter_counts_kernel" in e.name) / 1e3
            if dev else None,
            "inter_counts_launches": sum(1 for e in dev if "inter_counts_kernel" in e.name)
            if dev else None,
            "host_syncs": len(syncs),
            "host_sync_ms": sum(e.time_range.elapsed_us() for e in syncs) / 1e3,
            "host_copies": len(copies),
            "host_copy_ms": sum(e.time_range.elapsed_us() for e in copies) / 1e3}


def tree_split(pipe, group: str, aln) -> dict:
    """Where the alignment route's time goes, on phase ltr's tree of
    ``group``: the bootstrap NJ (nj_with_support: 1 + tree_boot distance
    matrices and NJ trees in a pool of 8 threads) rebuilt from its trimmed
    alignment, which must give the tree file again; one NJ tree and one
    bipartition set of it alone; the rest of phase ltr's ltr_tree seconds
    is the progressive MSA, trimming, rerooting and the files."""
    from subphaser_torch.ltr import msa, tree
    from subphaser_torch.ltr.native import nj_tree

    with open(f"{pipe.para_prefix}.{group}.tree.map") as f:
        names = [line.split("\t", 1)[0] for line in f]
    t0 = time.perf_counter()
    newick = msa.nj_with_support(aln, names, n_boot=pipe.tree_boot, device="cuda")
    boot_s = time.perf_counter() - t0
    with open(f"{pipe.para_prefix}.{group}.tree.nwk") as f:
        if tree.reroot_midpoint(newick) + "\n" != f.read():
            raise RuntimeError(f"the {group} tree rebuilt from its .trimal differs")
    dist = msa.kimura_distances(aln, device="cuda")
    t0 = time.perf_counter()
    main = nj_tree(dist, names)
    nj_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    msa._bipartitions(main)
    bip_s = time.perf_counter() - t0
    return {"ltr_tree_s": round(pipe.step_seconds["ltr_tree"], 3),
            "nj_with_support_s": round(boot_s, 3), "one_nj_tree_s": round(nj_s, 3),
            "one_bipartition_set_s": round(bip_s, 3),
            "msa_trim_reroot_files_s": round(pipe.step_seconds["ltr_tree"] - boot_s, 3)}


def phase_trees() -> dict:
    """Phase ltr's data: its enriched LTRs through the sketch route at real
    size, then both tree kernels at its real shapes and at edge shapes."""
    import numpy as np
    import torch

    from subphaser_torch.ltr import classify as tc
    from subphaser_torch.ltr import msa, tree

    pipe = LTR_RUN.pop("pipe", None)
    if pipe is None:
        raise RuntimeError("phase trees needs phase ltr's run")
    d_seqs = pipe.ltr_pipeline.d_seqs
    res = {}
    # the sketch route at real size, through build_ltr_trees
    out = os.path.join(WORK, "trees")
    os.makedirs(out, exist_ok=True)
    reset_tree_launches()
    t0 = time.perf_counter()
    built = tree.build_ltr_trees(pipe.enriched_ltrs, d_seqs, os.path.join(out, "sketch"),
                                 subsample=pipe.subsample, figfmt=pipe.figfmt, device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = tree_launches()
    leaves = {g: sum(1 for _ in open(mapfile)) for g, (_nwk, mapfile) in built.items()}
    chunks = sum(-(-(k * (k - 1) // 2) // tree.PAIR_CHUNK) for k in leaves.values())
    if not built or launches != {"match_counts": 0, "inter_counts": chunks}:
        raise RuntimeError(f"the sketch route built {leaves} with launches {launches}, "
                           f"not {chunks} inter_counts launches")
    res["sketch_route"] = {"seconds": round(seconds, 3), "leaves": leaves, "launches": launches}
    log(f"trees sketch route {json.dumps(res['sketch_route'])}")

    # match_counts on the largest group's trimmed alignment
    groups = {g: read_alignment(f"{pipe.para_prefix}.{g}.trimal")
              for g, suffixes in tree_files(pipe).items() if ".trimal" in suffixes}
    group = max(groups, key=lambda g: groups[g].shape[0])
    aln = groups[group]
    weight_sets = tree_weight_sets(aln.shape[1])
    rows = {w_name: check_match_counts(aln, w, True) for w_name, w in weight_sets.items()}
    edges = {}
    for n, length in ((1, 1), (1, 77), (63, 1), (63, 77), (65, 77), (65, 64)):
        a = random_alignment(n, length, n * 100 + length)
        for w_name, w in tree_weight_sets(length, n).items():
            edges[f"n={n} L={length} {w_name}"] = check_match_counts(a, w, False)["max_abs_err"]
    # the float route: fractional weights, 0.7 of the bootstrap counts + 0.1
    # (not multiples of a power of 2, so the float32 sums round)
    frac = check_match_counts_float(aln, fractional(weight_sets["multinomial"]))
    frac_edge = check_match_counts_float(random_alignment(65, 77, 9),
                                         fractional(tree_weight_sets(77, 65)["multinomial"]))
    # the float route through its entry point: kimura_distances with those weights
    frac_w = fractional(weight_sets["multinomial"])
    before = match_counts_routes()
    d_card = msa.kimura_distances(aln, weights=frac_w, device="cuda")
    after = match_counts_routes()
    if after != dict(before, float=before["float"] + 1):
        raise RuntimeError(f"kimura_distances with fractional weights: routes {before} -> {after}")
    d_err = float(np.abs(d_card - msa.kimura_distances(aln, weights=frac_w, device="cpu")).max())
    if not d_err <= 1e-3:  # the counts' float32 error through 1 - M/V and the log
        raise RuntimeError(f"kimura_distances, fractional weights: card - cpu = {d_err}")
    float_row = dict(rows["ones"]["float_route"], ms=frac["ms"], plain_ms=frac["plain_ms"],
                     path_launches={"trees_kimura_distances_fractional": 1},
                     kimura_max_abs_err=d_err,
                     library_ms=rows["ones"]["library_ms"],
                     max_abs_err=max(frac["max_abs_err"], frac_edge["max_abs_err"]),
                     checks={"n=767-path fractional": frac, "n=65 L=77 fractional": frac_edge},
                     by_weights={k: r["float_route"] for k, r in rows.items()})
    res["match_counts"] = dict(rows["ones"], group=group, by_weights=rows, edges=edges,
                               max_abs_err=max([r["max_abs_err"] for r in rows.values()]
                                               + list(edges.values())))
    res["match_counts_float"] = dict(float_row, n=aln.shape[0], L=aln.shape[1], group=group)
    log(f"trees match_counts {json.dumps(res['match_counts'])}")
    log(f"trees match_counts_float {json.dumps(res['match_counts_float'])}")
    res["tree_split"] = tree_split(pipe, group, aln)
    log(f"trees split of the ltr path's {group} tree {json.dumps(res['tree_split'])}")

    # inter_counts on the sketches of the first 1000 enriched LTRs
    ltrs = pipe.enriched_ltrs[:TREE_LEAVES]
    sketches = [tc._sketch(ltr.get_full_seq(d_seqs[ltr.seq_id])) for ltr in ltrs]
    pad, sizes = tree.pad_sketches(sketches)
    row = check_inter_counts(pad, sizes, True)
    if not np.array_equal(tree.mash_distances(sketches, device="cuda"),
                          tree.mash_distances(sketches, device="cpu")):
        raise RuntimeError("mash_distances differ between cuda and cpu")
    row["mash_distances"] = mash_waits(sketches)
    edges = {}
    for width in (37, 1):
        short = [x[:width] for x in sketches[:65]]
        short[3] = short[3][:0]  # an empty sketch
        for n in (2, 63, 65):
            p_h, sz = tree.pad_sketches(short[:n])
            edges[f"n={n} s={p_h.shape[1]}"] = check_inter_counts(p_h, sz, False)["max_abs_err"]
    wide = np.full((40, 1536), np.iinfo(np.int32).max, np.int32)  # 1536-wide rows
    rng = np.random.default_rng(1536)
    pool = np.unique(rng.integers(0, 2**31 - 1, size=4608)).astype(np.int32)
    for i in range(1, wide.shape[0]):  # row 0 all padding
        v = np.sort(rng.choice(pool, size=int(rng.integers(1, 1537)), replace=False))
        wide[i, :v.size] = v
    edges["n=40 s=1536"] = check_inter_counts(wide, (wide != wide.max()).sum(1), False)[
        "max_abs_err"]
    res["inter_counts"] = dict(row, edges=edges,
                               max_abs_err=max([row["max_abs_err"]] + list(edges.values())))
    log(f"trees inter_counts {json.dumps(res['inter_counts'])}")
    del pipe
    torch.cuda.empty_cache()
    log(f"phase trees ok: the sketch route at {leaves} leaves; match_counts bit-exact at "
        f"n={aln.shape[0]} L={aln.shape[1]} ({group}) and 6 edge shapes by the bits route, "
        f"within {frac['tolerance']:.3g} by the float route; inter_counts "
        f"bit-exact over {row['pairs']} pairs and {len(edges)} edge shapes; mash_distances "
        f"equal")
    return res


def main_genome() -> tuple[str, str, str]:
    t0 = time.perf_counter()
    paths = gen_genome(os.path.join(WORK, "main"), MAIN_SETS, MAIN_CHROM_MB)
    if time.perf_counter() - t0 > 1:
        log(f"main genome generated in {time.perf_counter() - t0:.1f} s")
    return paths


def reset_sort_launches() -> None:
    from subphaser_torch.ops import sort_smem

    sort_smem.launches = 0
    for route in sort_smem.route_launches:
        sort_smem.route_launches[route] = 0


def phase_main(k: int = 15) -> dict:
    """The 480 Mb run at ``k``: phase ``main`` (k = 15, int32 codes, dense
    mapping table) or ``main_k17`` (pair codes, searchsorted mapping)."""
    import torch

    from subphaser_torch.ops import count, sort_smem

    phase = "main" if k == 15 else f"main_k{k}"
    fa, cfg, _hmm = main_genome()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_sort_launches()
    run_launches0 = dict(count.entry_launches)
    t0 = time.perf_counter()
    pipe = run_cli(fa, cfg, os.path.join(WORK, phase), "-k", str(k), "-min_freq", "200")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sort_smem.launches
    by_route = dict(sort_smem.route_launches)
    run_launches = {e: n - run_launches0[e] for e, n in count.entry_launches.items()}
    if not run_launches["rn_count64" if k > 15 else "rn_count"]:
        raise RuntimeError(f"the run kernel was not launched on the {phase} path")
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
        "run_launches": run_launches,
        "sig_kmers": len(kmers),
        "assignments": read_assignments(pipe),
    }
    if k == 15:
        MAIN_RUN["pipe"] = pipe  # phase stats works on this run's data
        PARALLEL_INPUTS.update(genome=pipe.genome, labels=pipe.chrom_labels, sgs=pipe.sgs,
                               nsg=pipe.nsg, tile_bases=pipe.tile_bases, tmpdir=pipe.tmpdir,
                               lower_count=pipe.lower_count, min_freq=pipe.min_freq,
                               replicates=pipe.replicates, prefix=pipe.para_prefix)
    log(f"{phase} " + json.dumps(result))
    log(f"phase {phase} ok: {mbp:.0f} Mb phased at k = {k}, "
        f"{'dense' if pipe.map_dense else 'searchsorted'} mapping, {launches} sort launches")
    return result


MAIN_RUN: dict = {}


def read_bin_counts(path: str):
    """The (bins, SG) int64 count columns of a .subgenome.bin.count."""
    import numpy as np

    with open(path) as f:
        rows = [line.rstrip("\n").split("\t")[3:] for line in f if not line.startswith("#")]
    return np.array(rows, dtype=np.int64)


def fisher_walks(tables, max_terms: int, copies: int = 1) -> dict:
    """How long each table's Fisher walk is, by a float32 walk of this
    script's own on the card (torch ops on the tables still walking, not
    the kernel): the terms to the end (an invalid term, a -inf log term or
    max_terms terms) and to the stop the kernel's exits allow (log_sum >=
    0; after a term with a ratio <= 1 - 2^-16, a gap log_sum - log_term
    above (25 - floor(log2 |log_sum|)) ln 2 + 1e-3, or 150 where |log_sum| <
    2^-100). The max, 99th percentile and total of each, and the table
    whose stop comes last. Where the tables are ``copies`` equal copies of
    their first 1 / copies (a tiled count matrix: the margins are the whole
    matrix's), the first copy is walked and the totals multiplied."""
    import math

    import torch

    a, b, c, d = (t[:t.numel() // copies] for t in tables)
    m, n1, k1 = a + b + c + d, a + b, a + c
    upper, mk = torch.minimum(n1, k1), m - n1 - k1

    def lchoose(x, y):
        return torch.lgamma(x + 1.0) - torch.lgamma(y + 1.0) - torch.lgamma(x - y + 1.0)

    lp0 = lchoose(n1, a) + lchoose(m - n1, k1 - a) - lchoose(m, k1)
    n = a.numel()
    to_end = torch.zeros(n, dtype=torch.int64, device=a.device)
    to_stop = torch.full((n,), -1, dtype=torch.int64, device=a.device)
    live = torch.arange(n, device=a.device)
    s, t = lp0.clone(), lp0.clone()
    for i in range(max_terms):
        if live.numel() == 0:
            break
        x = a[live] + float(i)
        ratio = ((n1[live] - x) * (k1[live] - x)) / ((x + 1.0) * (mk[live] + x + 1.0))
        t_new = t + torch.log(ratio.clamp_min(1e-38))
        go = (x < upper[live]) & (ratio > 0) & (t_new != -math.inf)
        live, s, t, ratio, x = live[go], s[go], t_new[go], ratio[go], x[go]
        s = torch.logaddexp(s, t)
        to_end[live] = i + 1
        e = torch.floor(torch.log2(s.abs())).clamp(-1000, 1000)
        gap = torch.where(e >= -100, (25.0 - e) * math.log(2) + 1e-3, 150.0)
        stop = (s >= 0) | ((ratio <= 1 - 2.0 ** -16) & (x + 1 > 0) & (s - t > gap))
        stop &= to_stop[live] < 0
        to_stop[live[stop]] = i + 1
    to_stop = torch.where(to_stop < 0, to_end, to_stop)

    def summary(walk):
        p99 = torch.kthvalue(walk, max(1, math.ceil(0.99 * n))).values
        return {"max": int(walk.max()), "p99": int(p99), "total": int(walk.sum()) * copies}
    return {"to_end": summary(to_end), "to_stop": summary(to_stop),
            "longest_table": int(torch.argmax(to_stop))}


def fisher_bounds(tables, max_terms: int, int32_rate: dict, terms: float | None = None) -> dict:
    """fisher_right_tail's bound on these tables: the terms the recurrence
    runs (``terms``; by default min(upper - a, max_terms) a table, 0 where
    a > upper) at three special-function calls a term over the SFU's 16 a
    clock an SM at the maximum SM clock, against FISHER_OPS_PER_TERM
    float32 operations a term at 67 TFLOP/s and 20 bytes a table at 3.35
    TB/s; the largest."""
    import torch

    a, b, c, _d = (t.double() for t in tables)
    if terms is None:
        terms = float(torch.clamp(torch.minimum(a + b, a + c) - a, 0, max_terms).sum())
    n = tables[0].numel()
    sfu_per_s = SFU_OPS_PER_CLOCK_PER_SM * int32_rate["sms"] * int32_rate["sm_clock_mhz"] * 1e6
    sfu_ms = 3 * terms / sfu_per_s * 1e3
    fp32_ms = FISHER_OPS_PER_TERM * terms / FP32_OPS_PER_S * 1e3
    bytes_bound = bytes_ms(20 * n)
    bound = max(sfu_ms, fp32_ms, bytes_bound)
    return {"tables": n, "terms": terms, "sfu_ms": sfu_ms, "fp32_ms": fp32_ms,
            "bytes_ms": bytes_bound, "bound_ms": bound,
            "bound_by": "bytes" if bound == bytes_bound else "operations"}


def fisher_chain(tables, table: int, walk: int, clock_mhz: float) -> dict:
    """The cycles a term of one walk costs on the chain: the kernel on the
    table ``table`` alone, its walk cut at ``walk`` and at half of it
    (max_terms), queued launches; the difference over the terms between
    them, at the maximum SM clock. With the longest walk it gives the floor
    that walk sets: walk x cycles a term."""
    import torch

    from subphaser_torch.ops import stats

    lib = stats.stats_lib()
    one = [t[table:table + 1].contiguous() for t in tables]
    out = torch.empty(1, dtype=torch.float32, device="cuda")
    scratch = torch.empty(lib.st_fisher_scratch_size(1), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(max_terms):
        def go():
            if lib.st_fisher_right_tail(*(t.data_ptr() for t in one), 1, max_terms,
                                        out.data_ptr(), scratch.data_ptr(), stream) != 0:
                raise RuntimeError("st_fisher_right_tail launch failed")
        return go
    full, half = queued_ms(launch(walk), calls=5), queued_ms(launch(walk // 2), calls=5)
    cycles = (full - half) / (walk - walk // 2) * clock_mhz * 1e3
    return {"walk": walk, "walk_ms": full, "half_walk_ms": half, "cycles_per_term": cycles,
            "chain_floor_ms": walk * cycles / (clock_mhz * 1e3)}


def same_bits(x, y) -> bool:
    """Equal float tensors bit for bit, NaN where the other is NaN."""
    import torch

    nan = torch.isnan(x)
    return bool(torch.equal(nan, torch.isnan(y))
                and torch.equal(torch.where(nan, 0.0, x).view(torch.int32),
                                torch.where(nan, 0.0, y).view(torch.int32)))


def pca_check(cluster, n: int) -> dict:
    """PhaseCluster.pca on the card against the same cluster's data on the
    CPU: scores within 1e-3 after z-scoring in every column whose
    eigenvalue is resolved (its ratio apart from its neighbours' by more
    than PCA_GAP; a column of near-equal eigenvalues is any rotation of its
    pair and is only reported), ratios within 1e-5. The leading column
    must be resolved."""
    import copy

    import numpy as np

    t0 = time.perf_counter()
    s_gpu, r_gpu = cluster.pca(n)
    gpu_s = time.perf_counter() - t0
    cpu = copy.copy(cluster)
    cpu._data = cluster._data.cpu()
    t0 = time.perf_counter()
    s_cpu, r_cpu = cpu.pca(n)
    cpu_s = time.perf_counter() - t0
    _, r_all = cpu.pca(len(cluster.chrs))  # the neighbours of the last column
    gaps = np.abs(np.diff(np.concatenate([[np.inf], r_all, [-np.inf]])))
    resolved = [i for i in range(s_gpu.shape[1]) if min(gaps[i], gaps[i + 1]) > PCA_GAP]
    col_err = np.abs(s_gpu - s_cpu).max(axis=0)
    ratio_err = float(np.abs(r_gpu - r_cpu).max())
    if 0 not in resolved or max(col_err[resolved]) > 1e-3 or ratio_err > 1e-5:
        raise RuntimeError(f"PCA on the card disagrees with the CPU: column errors {col_err}, "
                           f"resolved {resolved}, ratio error {ratio_err}")
    return {"n_components": n, "chroms": len(cluster.chrs), "kmers": cluster._data.shape[1],
            "ratio": r_gpu.tolist(), "resolved_columns": resolved,
            "score_max_abs_err_by_column": col_err.tolist(), "ratio_max_abs_err": ratio_err,
            "cuda_s": gpu_s, "cpu_s": cpu_s}


def host_pvals_sample(counts, reps: int, budget_s: float = STATS_HOST_BUDGET_S):
    """stats_host's float64 p-values of np.tile(counts, (reps, 1)) on a
    seeded random sample of counts' rows, in chunks of STATS_HOST_CHUNK rows until
    ``budget_s`` has passed (all rows where they fit): every tile's tables
    are the same, as the margins are the whole matrix's, so a row's tables
    stand for all its copies. (scipy's float64 tail takes far longer a
    table at a 14 Gb genome's margins on some installations.) Returns
    (row indices, p-values (rows, SG)); at reps = 1 the function's tables
    are held to stats_host.fisher_enrich_pvals."""
    import numpy as np

    from subphaser_torch.ops import stats_host

    total = counts.sum(axis=0) * reps
    grand = total.sum()
    order = np.random.default_rng(0).permutation(counts.shape[0])
    done, parts = 0, []
    t0 = time.perf_counter()
    while done < order.size and (not parts or time.perf_counter() - t0 < budget_s):
        x11 = counts[order[done:done + STATS_HOST_CHUNK]]
        x12 = x11.sum(axis=1, keepdims=True) - x11
        x21u = total[None, :] - x11
        x22 = np.minimum(grand - x21u - x12, stats_host.MAX_INT)
        x21 = np.minimum(x21u, stats_host.MAX_INT)
        parts.append(stats_host.fisher_right_tail(x11, x12, x21, x22))
        done += x11.shape[0]
    rows, p = order[:done], np.concatenate(parts)
    if reps == 1 and done == order.size and \
            not np.array_equal(p, stats_host.fisher_enrich_pvals(counts)[rows]):
        raise RuntimeError("host_pvals_sample disagrees with stats_host.fisher_enrich_pvals")
    return rows, p


def phase_stats() -> dict:
    """ops/stats and the PCA at real size: fisher_enrich_pvals through its
    entry point on phase main's bin counts and tiled to a 14 Gb wheat's
    bins (the path: counts reset before, read after), the kernel against
    its plain version on the card and the decisions against the host
    float64 test; bh_fdr, the t-test, Mann-Whitney and Kruskal on the card
    against the CPU; PhaseCluster.pca on the card against the CPU."""
    import numpy as np
    import torch

    from subphaser_torch import kernels
    from subphaser_torch.ops import stats

    pipe = MAIN_RUN.pop("pipe", None)
    if pipe is None:
        raise RuntimeError("phase stats needs phase main's run")
    res = {"launches_before": dict(stats.launches)}  # every phasing path so far
    if stats.launches["fisher_right_tail"] != 0:
        raise RuntimeError(f"fisher_right_tail launched on a phasing path: {stats.launches}")
    counts = read_bin_counts(pipe.para_prefix + ".subgenome.bin.count")
    reps = -(-STATS_WHEAT_BINS // counts.shape[0])
    inputs = {"main": counts, "wheat_14gb": np.tile(counts, (reps, 1))}
    dev = {name: torch.from_numpy(c).cuda() for name, c in inputs.items()}
    stats.launches["fisher_right_tail"] = 0
    pvals = {name: stats.fisher_enrich_pvals(x) for name, x in dev.items()}
    torch.cuda.synchronize()
    res["launches"] = stats.launches["fisher_right_tail"]
    if res["launches"] != len(dev):
        raise RuntimeError(f"fisher_enrich_pvals launched the kernel {res['launches']} times "
                           f"for {len(dev)} calls")
    _ops, int32_rate = card_int32_ops_per_s()
    lib = stats.stats_lib()
    stream = torch.cuda.current_stream().cuda_stream
    for name, x in dev.items():
        tables = [t.contiguous() for t in stats.enrich_tables(x)]
        got = pvals[name]
        log(f"stats {name}: {tables[0].numel()} tables")
        t0 = time.perf_counter()
        want = stats.fisher_right_tail_plain(*tables)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        log(f"stats {name}: plain version {plain_ms / 1e3:.1f} s")
        g, w = got.cpu().numpy(), want.cpu().numpy()
        m = w > 1e-30
        rel = float(np.max(np.abs(g[m] - w[m]) / w[m])) if m.any() else 0.0
        if rel > 1e-4 or not np.array_equal(g <= 0.05, w <= 0.05) \
                or not np.array_equal(np.isnan(g), np.isnan(w)) or not same_bits(got, want):
            raise RuntimeError(f"stats {name}: fisher_right_tail disagrees with its plain "
                               f"version (max rel {rel} on p > 1e-30, or not bit for bit)")
        flat = [t.reshape(-1) for t in tables]
        t0 = time.perf_counter()
        copies = inputs[name].shape[0] // counts.shape[0]
        if not np.array_equal(inputs[name][:counts.shape[0]], counts):
            raise RuntimeError(f"stats {name}: not copies of phase main's bins")
        walks = fisher_walks(flat, 16384, copies)
        log(f"stats {name}: walks {json.dumps(walks)} ({time.perf_counter() - t0:.1f} s)")
        out = torch.empty_like(tables[0])
        scratch = torch.empty(lib.st_fisher_scratch_size(out.numel()), dtype=torch.int32,
                              device="cuda")

        def launch():
            if lib.st_fisher_right_tail(*(t.data_ptr() for t in tables), out.numel(), 16384,
                                        out.data_ptr(), scratch.data_ptr(), stream) != 0:
                raise RuntimeError("st_fisher_right_tail launch failed")
        t0 = time.perf_counter()
        rows, host = host_pvals_sample(counts, inputs[name].shape[0] // counts.shape[0])
        host_s = time.perf_counter() - t0
        log(f"stats {name}: host float64 {host_s:.1f} s on {rows.size} of {counts.shape[0]} "
            f"rows")
        row = {
            "shape": list(inputs[name].shape), "grand_total": int(inputs[name].sum()),
            "max_rel_err": rel, "max_abs_err": float(np.nanmax(np.abs(g - w))),
            "ms": time_ms(lambda: stats.fisher_right_tail(*tables)),
            "device_ms": queued_ms(launch, calls=5),
            "kernel_launches_a_call": kernels.graph_kernel_launches(
                lambda: stats.fisher_right_tail(*tables)),
            "plain_ms": plain_ms, "library_ms": None,
            "walks": walks,
            # the bound on the terms the stops leave, and on the terms to the end
            **fisher_bounds(tables, 16384, int32_rate, walks["to_stop"]["total"]),
            "bound_to_end": fisher_bounds(tables, 16384, int32_rate),
            "chain": fisher_chain(flat, walks["longest_table"], walks["to_stop"]["max"],
                                  int32_rate["sm_clock_mhz"]),
            "host_float64_s": host_s,
            "host_float64_tables": int(host.size),
            "decisions_at_005": int((g[rows] <= 0.05).sum()),
            "host_decisions_at_005": int((host <= 0.05).sum()),
            "share_agreeing_with_host_float64": float(np.mean((g[rows] <= 0.05)
                                                              == (host <= 0.05))),
        }
        if row["kernel_launches_a_call"] != 2:
            raise RuntimeError(f"fisher_right_tail launched {row['kernel_launches_a_call']} "
                               "kernels a call, not 2")
        row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
        row["share_of_chain_floor"] = row["chain"]["chain_floor_ms"] / row["device_ms"]
        log(f"stats {name}: kernel {row['ms']:.3f} ms, device {row['device_ms']:.3f} ms, "
            f"bound {row['bound_ms']:.4f} ms (to the end {row['bound_to_end']['bound_ms']:.4f}), "
            f"chain floor {row['chain']['chain_floor_ms']:.4f} ms")
        res[name] = row
    stats.launches["fisher_right_tail"] = 0  # the later phases' paths: read at the end
    t0 = time.perf_counter()
    res["others"] = other_stats_check(pipe, pvals["main"])
    log(f"stats: the other functions {time.perf_counter() - t0:.1f} s")
    res["pca"] = pca_check(pipe.cluster, max(2, pipe.nsg))
    log(f"stats {json.dumps(res)}")
    log(f"phase stats ok: fisher_right_tail within rel {max(res[n]['max_rel_err'] for n in dev)}"
        f" of its plain version at {[res[n]['tables'] for n in dev]} tables, decisions equal; "
        f"{res['main']['share_agreeing_with_host_float64']:.6f} / "
        f"{res['wheat_14gb']['share_agreeing_with_host_float64']:.6f} of decisions as the host "
        f"float64 test's; the other functions and the PCA cuda == cpu")
    return res


def other_stats_check(pipe, pvals) -> dict:
    """bh_fdr of phase main's Fisher p-values, and the t-test, Mann-Whitney
    and Kruskal of its k-mer matrix (the first STATS_KMERS rows, the two
    groups of the first two subgenomes; Kruskal over all), on the card
    against the CPU, at the CPU tests' tolerances."""
    import numpy as np
    import torch

    from subphaser_torch.ops import stats

    freqs = pipe.cluster.freqs[:STATS_KMERS]
    groups = pipe.cluster.group_idx_by_sg()
    g1, g2 = freqs[:, groups[0]], freqs[:, groups[1]]
    everything = np.concatenate([freqs[:, g] for g in groups], axis=1)
    sizes = np.array([len(g) for g in groups])
    t_args = (g1.mean(1), g1.var(1, ddof=1), np.full(len(freqs), float(g1.shape[1])),
              g2.mean(1), g2.var(1, ddof=1), np.full(len(freqs), float(g2.shape[1])))
    calls = {
        "bh_fdr": (lambda dev: stats.bh_fdr(pvals.reshape(-1).to(dev)), dict(rtol=1e-5)),
        "ttest_ind_from_stats": (lambda dev: stats.ttest_ind_from_stats(
            *(torch.from_numpy(a).to(dev) for a in t_args)), dict(rtol=2e-4, atol=1e-6)),
        "mannwhitneyu": (lambda dev: stats.mannwhitneyu(torch.from_numpy(g1).to(dev),
                                                        torch.from_numpy(g2).to(dev)),
                         dict(rtol=1e-4)),
        "kruskal": (lambda dev: stats.kruskal(torch.from_numpy(everything).to(dev), sizes),
                    dict(rtol=1e-4)),
    }
    out = {}
    for name, (fn, tol) in calls.items():
        t0 = time.perf_counter()
        got = fn("cuda").cpu().numpy()
        cuda_s = time.perf_counter() - t0
        want = fn("cpu").numpy()
        np.testing.assert_allclose(got, want, **tol, err_msg=f"stats {name}: cuda != cpu")
        ok = ~np.isnan(want)
        out[name] = {"n": int(got.size), "nan": int((~ok).sum()), "cuda_s": cuda_s,
                     "max_abs_err": float(np.max(np.abs(got[ok] - want[ok]), initial=0.0))}
    return out


def tree_kernel_entries(res: dict) -> list[dict]:
    """The kernels-line entries of the LTR trees' counts (hand-written
    kernels of XLA-lowered functions), from phases parity, ltr and trees:
    their numbers are phase trees' at real shapes; match_counts launches on
    the ltr path (the alignment route), inter_counts on the sketch route at
    real size (phase trees), as the ltr path's groups all carry peptides.
    match_counts has two entries, its bits route (the one every path
    takes) and its float route (match_counts_kernel, for non-integer weights):
    the float route's device time is its bare kernel on the bits route's
    inputs, its error and wrapper time on fractional weights."""
    tr = res["trees"]
    entries = []
    for name, pattern, needle in (("match_counts", "*/ltr/msa.py", "def _match_counts"),
                                  ("match_counts_float", "*/ltr/msa.py", "def _match_counts"),
                                  ("inter_counts", "*/ltr/tree.py", "    def inter_counts")):
        row = tr[name]
        counter = "match_counts" if name.startswith("match_counts") else name
        by_path = {"ltr": res["ltr"]["launches"][counter],
                   "ltr_sketch_route": tr["sketch_route"]["launches"][counter],
                   **{f"parity_{run}": counts[counter]
                      for run, counts in res["parity"]["launches"].items()}}
        entry = {
            "name": name,
            "route": "cuda",
            "source": "subphaser_torch/csrc/tree_counts.cu",
            "replaces": tpu_kernel_site(pattern, needle),
            "launches": by_path["ltr"] or by_path["ltr_sketch_route"],
            "launches_by_path": by_path,
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "device_ms", "profiler_ms",
                                         "share_of_bound")},
            "shape": {key: row[key] for key in ("n", "L", "s", "pairs", "timed_pairs", "group")
                      if key in row},
        }
        if name == "match_counts":  # the ltr path's launches, all by this route
            entry["launches"] = res["ltr"]["launches_by_route"]["match_counts"]["bits"]
            entry["launches_by_route_on_ltr"] = res["ltr"]["launches_by_route"]["match_counts"]
        if name == "match_counts_float":  # on no path: kimura_distances on fractional weights
            entry["launches_by_path"] = dict(row["path_launches"], ltr=res["ltr"][
                "launches_by_route"]["match_counts"]["float"])
            entry["launches"] = row["path_launches"]["trees_kimura_distances_fractional"]
        if name == "inter_counts":
            entry.update({key: row[key] for key in ("ms_index_check_on_card",
                                                    "kernel_launches_a_call", "mash_distances")})
        if name == "match_counts":
            entry.update({key: row[key] for key in ("bytes_bound_ms", "popcount_bound_ms",
                                                    "profiler_split_ms", "expanded_columns")})
            entry["float_route_bound_ms"] = row["float_route"]["bound_ms"]
        entries.append(entry)
    return entries


def phase_blocks() -> dict:
    """The default run on the 480 Mb genome, resumed from phase ltr's
    checkpoints (a copy of its tmpdir)."""
    import torch

    from subphaser_torch.blocks.paf import parse_paf
    from subphaser_torch.ops import anchors

    fa, cfg, hmm = main_genome()
    src = os.path.join(WORK, "ltr", "tmp")
    work = os.path.join(WORK, "blocks")
    if not os.path.isdir(src):
        raise RuntimeError("phase blocks needs phase ltr's tmpdir")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(src, os.path.join(work, "tmp"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_anchor_launches()
    t0 = time.perf_counter()
    pipe = run_cli(fa, cfg, work, "-k", "15", "-min_freq", "200", ltr=["-hmm_db", hmm],
                   blocks=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = anchor_launches()
    pafs = block_pafs(os.path.join(work, "tmp"))
    pairs = {}
    for name, path in pafs.items():
        recs = list(parse_paf(path))
        good = [r for r in recs if r.tags.get("tp") == "P" and "cs" in r.tags
                and r.qspan >= pipe.min_block]
        covered, end = 0, 0
        for a, b in sorted((r.qstart, r.qend) for r in recs):
            covered += max(0, b - max(a, end))
            end = max(end, b)
        pairs[name] = {"blocks": len(recs), "primary_ge_min_block": len(good),
                       "query_bases_covered": covered,
                       "qlen": recs[0].qlen if recs else None}
    if len(pafs) != 6 or any(p["primary_ge_min_block"] == 0 for p in pairs.values()):
        raise RuntimeError(f"blocks: want 6 PAFs with a primary block each: {pairs}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"the blocks path launched no {launches}")
    BLOCKS_RUN["pipe"] = pipe
    result = {
        "genome_mbp": pipe.genome.total_bases() / 1e6,
        "wall_s": round(wall, 3),
        "step_s": {s: round(pipe.step_seconds[s], 3) for s in BLOCK_STEPS},
        "other_step_s": {s: round(v, 3) for s, v in pipe.step_seconds.items()
                         if s not in BLOCK_STEPS},
        "pairs": pairs,
        "launches": launches,
        "entry_launches": dict(anchors.entry_launches),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    log("blocks " + json.dumps(result))
    log(f"phase blocks ok: {len(pafs)} PAFs, {sum(p['blocks'] for p in pairs.values())} blocks, "
        f"blocks {result['step_s']['blocks']} s of circos {result['step_s']['circos']} s, "
        f"launches {json.dumps(launches)}")
    return result


BLOCKS_RUN: dict = {}


def bytes_ms(n_bytes: int) -> float:
    return n_bytes / HBM_BYTES_PER_S * 1e3


def phase_anchors() -> dict:
    """Kernels A and B held to their plain versions on the card, at the
    blocks path's shapes (phase blocks' genome) and at edge cases."""
    import numpy as np
    import torch

    from subphaser_torch import kernels
    from subphaser_torch.io.genome import tile_words_for
    from subphaser_torch.ops import anchors as an

    genome = BLOCKS_RUN["pipe"].genome
    k, mod, tile = 15, 16, 1 << 23
    W, n_words, cap = tile // 16, tile_words_for(tile, k), an._base_cap(tile, mod)
    a1 = genome.chrom("A1")
    first = an._tile_words(a1, 0, n_words)
    tiles = {"A1_first": first,
             "A1_last": an._tile_words(a1, (a1.length - 1) // tile * tile, n_words),
             "invalid": (first[0], np.zeros_like(first[1]))}
    kw = dict(k=k, n_pos_words=W, mod=mod)
    res = {"sampled_anchors": {"by_tile": {}, "max_abs_err": 0},
           "match_emit": {"by_case": {}, "max_abs_err": 0}}
    for name, (w_h, v_h) in tiles.items():
        w, v = torch.from_numpy(w_h).cuda(), torch.from_numpy(v_h).cuda()
        got = an.sampled_anchors(w, v, cap=cap, **kw)
        want = an.sampled_anchors_plain(w, v, cap=cap, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"sampled_anchors disagrees with its plain version on {name}")
        n = int(got[3])
        res["sampled_anchors"]["by_tile"][name] = {"n_total": n}
        if name != "A1_first":
            continue
        small = n // 3
        low = an.sampled_anchors(w, v, cap=small, **kw)
        plain_low = an.sampled_anchors_plain(w, v, cap=small, **kw)
        if not (all(torch.equal(a, b) for a, b in zip(low, plain_low))
                and all(torch.equal(a, b[:small]) for a, b in zip(low[:3], got[:3]))
                and int(low[3]) == n):
            raise RuntimeError("sampled_anchors at a cap below its count: prefix or count "
                               "differ")
        res["sampled_anchors"]["by_tile"]["A1_first_cap_below"] = {"cap": small, "n_total": n}
        lib = an.anchors_lib()
        outs = [torch.empty(cap, dtype=torch.int32, device="cuda") for _ in range(3)]
        n_total = torch.empty((), dtype=torch.int32, device="cuda")
        scratch = torch.empty(lib.an_sample_scratch_size(W), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def bare_a():
            if lib.an_sampled_anchors(w.data_ptr(), v.data_ptr(), k, W, an._threshold(mod),
                                      cap, *(o.data_ptr() for o in outs),
                                      n_total.data_ptr(), scratch.data_ptr(), stream) != 0:
                raise RuntimeError("an_sampled_anchors launch failed")
        kernels_a_call = kernels.graph_kernel_launches(
            lambda: an.sampled_anchors(w, v, cap=cap, **kw))
        if kernels_a_call != 2:
            raise RuntimeError(f"sampled_anchors launched {kernels_a_call} kernels a call, not 2")
        res["sampled_anchors"].update(
            kernel_launches_a_call=kernels_a_call,
            ms=time_ms(lambda: an.sampled_anchors(w, v, cap=cap, **kw)),
            device_ms=queued_ms(bare_a),
            profiler_split_ms={name: device_ms(lambda _x: bare_a(), None, name, required=False)
                               for name in ("sample_count_kernel", "sample_write_kernel")},
            plain_ms=time_ms(lambda: an.sampled_anchors_plain(w, v, cap=cap, **kw), 3),
            bound_ms=bytes_ms(2 * 4 * n_words + 3 * 4 * cap + 4),
            shape={"tile_bases": tile, "words": n_words, "cap": cap, "mod": mod,
                   "n_total": n})
    # kernel B: the pair A1-B1 whole, then no kept run and every run max_occ long
    qa = an.chrom_anchors_dev(a1, k=k, mod=mod, device="cuda")
    ta = an.chrom_anchors_dev(genome.chrom("B1"), k=k, mod=mod, device="cuda")
    q_occ = qa.occ()
    tc_s, tp_s, ts_s = ta.sorted3()
    lo, hi = an._ss_left_right(tc_s, qa.c)
    n8 = 400_000
    tc8 = torch.arange(n8, device="cuda", dtype=torch.int32).repeat_interleave(8)
    qc8 = torch.randperm(n8, device="cuda").to(torch.int32)
    lo8, hi8 = an._ss_left_right(tc8, qc8)
    pos8 = torch.arange(tc8.numel(), dtype=torch.int32, device="cuda")
    # every kept run of the pair inside one tile of the scan (2,048 queries)
    q_tile = torch.arange(qa.c.numel(), device="cuda") // 2048 == 1000
    # more than 2^20 queries at a random keep rate
    g = torch.Generator(device="cuda").manual_seed(14)
    n_r = (1 << 20) + 12345
    rate = float(torch.rand(1, generator=g, device="cuda")) * 0.5 + 0.05
    lo_r = torch.randint(0, 1 << 22, (n_r,), generator=g, device="cuda", dtype=torch.int32)
    run_r = torch.randint(1, 10, (n_r,), generator=g, device="cuda", dtype=torch.int32)
    run_r *= torch.rand(n_r, generator=g, device="cuda") < rate
    qc_r = torch.randint(0, 1 << 30, (n_r,), generator=g, device="cuda", dtype=torch.int32)
    qc_r[torch.rand(n_r, generator=g, device="cuda") < 0.05] = an.SENTINEL
    t_r = torch.randint(0, 1 << 30, ((1 << 22) + 9,), generator=g, device="cuda",
                        dtype=torch.int32)
    cases = {
        "pair_A1_B1": (qa.c, q_occ, qa.p, qa.s, tp_s, ts_s, lo, hi),
        "no_kept_run": (qa.c, q_occ, qa.p, qa.s, tp_s, ts_s, lo, lo),
        "all_runs_max_occ": tuple(x.to(torch.int32) for x in (
            qc8, torch.ones_like(qc8), qc8 * 3, qc8 & 1, pos8, pos8 % 3 == 0, lo8, hi8)),
        "kept_in_one_tile": (qa.c, q_occ, qa.p, qa.s, tp_s, ts_s, lo,
                             torch.where(q_tile, hi, lo)),
        "below_one_tile": tuple(x[:1000] for x in (qa.c, q_occ, qa.p, qa.s)) + (tp_s, ts_s)
        + (lo[:1000], hi[:1000]),
        "over_2^20_random": (qc_r, torch.randint(1, 10, (n_r,), generator=g, device="cuda",
                                                 dtype=torch.int32),
                             qc_r ^ 5, qc_r & 1, t_r, t_r & 1, lo_r, lo_r + run_r),
    }
    for name, args in cases.items():
        got = an.match_emit(*args, max_occ=8)
        want = an.match_emit_plain(*args, max_occ=8)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"match_emit disagrees with its plain version on {name}")
        res["match_emit"]["by_case"][name] = {"queries": args[0].numel(),
                                              "targets": args[4].numel(),
                                              "pairs": got[0].numel()}
    by_case = res["match_emit"]["by_case"]
    if by_case["no_kept_run"]["pairs"] != 0 or by_case["all_runs_max_occ"]["pairs"] != 8 * n8 \
            or not 0 < by_case["kept_in_one_tile"]["pairs"] < by_case["pair_A1_B1"]["pairs"] \
            or by_case["below_one_tile"]["pairs"] == 0:
        raise RuntimeError(f"match_emit edge cases: {by_case}")
    by_case["over_2^20_random"]["keep_rate"] = rate
    args = tuple(x.contiguous() for x in cases["pair_A1_B1"])
    n_q, n_t = args[0].numel(), args[4].numel()
    n_pairs = by_case["pair_A1_B1"]["pairs"]
    runs = hi - lo
    keep = (runs > 0) & (runs <= 8) & (q_occ <= 8) & (qa.c != an.SENTINEL)
    n_kept = int(keep.sum())
    # the 32-byte sectors the gathers touch: qp and qs at the kept queries,
    # tp_s and ts_s at each kept run's targets
    lens = runs[keep].long()
    t_idx = torch.repeat_interleave(lo[keep].long() - (torch.cumsum(lens, 0) - lens), lens) \
        + torch.arange(int(lens.sum()), device="cuda")
    sectors = 2 * torch.unique(torch.nonzero(keep).squeeze(1) // 8).numel() \
        + 2 * torch.unique(t_idx // 8).numel()
    lib = an.anchors_lib()
    outs = [torch.empty(max(n_pairs, 1), dtype=torch.int32, device="cuda") for _ in range(3)]
    scratch = torch.empty(lib.an_match_scratch_size(n_q), dtype=torch.int32, device="cuda")
    totals = torch.empty(2, dtype=torch.int32, device="cuda")
    qc_p, qo_p, qp_p, qs_p, tp_p, ts_p, lo_p, hi_p = (x.data_ptr() for x in args)

    def bare_b():  # the scan and the emit, without the host's read of the totals
        stream = torch.cuda.current_stream().cuda_stream  # a graph captures on its own
        if (lib.an_match_scan(qc_p, qo_p, lo_p, hi_p, qp_p, qs_p, n_q, 8, totals.data_ptr(),
                              scratch.data_ptr(), stream)
                or lib.an_match_emit(tp_p, ts_p, n_q, scratch.data_ptr(), n_kept, n_pairs,
                                     *(o.data_ptr() for o in outs), stream)):
            raise RuntimeError("an_match_scan/an_match_emit launch failed")
    kernels_b_call = kernels.graph_kernel_launches(bare_b)
    if kernels_b_call != 2:
        raise RuntimeError(f"match_emit's entries launched {kernels_b_call} kernels, not 2")
    res["match_emit"].update(
        kernel_launches_a_call=kernels_b_call,
        ms=time_ms(lambda: an.match_emit(*args, max_occ=8)),
        device_ms=queued_ms(bare_b),
        profiler_split_ms={name: device_ms(lambda _x: bare_b(), None, name, required=False)
                           for name in ("match_scan_kernel", "match_emit_kernel")},
        plain_ms=time_ms(lambda: an.match_emit_plain(*args, max_occ=8), 3),
        # The bytes this pair needs: the four arrays of the keep rule for every
        # query, positions and strands of the kept queries, the two target
        # arrays at the gathered entries only, and three outputs a pair.
        bound_ms=bytes_ms(4 * (4 * n_q + 2 * n_kept + 5 * n_pairs)),
        # the same with each gather read as the whole 32-byte sectors it touches
        sector_bound_ms=bytes_ms(4 * 4 * n_q + 32 * sectors + 12 * n_pairs),
        # beyond them: the compact list of the kept queries (16 B each),
        # written by the scan and read by the emit
        compact_list_bytes=16 * n_kept, compact_list_ms=bytes_ms(32 * n_kept),
        shape={"pair": "A1-B1", "queries": n_q, "kept_queries": n_kept, "targets": n_t,
               "pairs": n_pairs})
    for name in ANCHOR_KERNELS:
        row = res[name]
        row.update(bound_by="bytes", library_ms=None,
                   share_of_bound=row["bound_ms"] / row["device_ms"])
        log(f"anchors {name} " + json.dumps(row))
    log(f"phase anchors ok: sampled_anchors bit-exact on {len(res['sampled_anchors']['by_tile'])} "
        f"tiles in 2 kernel launches a call, match_emit on {len(by_case)} cases")
    return res


def anchor_kernel_entries(res: dict) -> list[dict]:
    """The kernels-line entries of the anchor kernels (hand-written kernels
    of XLA-lowered functions): their numbers are phase anchors', their
    launches phase blocks' (the default run at 480 Mb)."""
    entries = []
    for name, needle in ANCHOR_KERNELS.items():
        row = res["anchors"][name]
        by_path = {"blocks": res["blocks"]["launches"][name],
                   "parity_default": res["parity"]["anchor_launches"][name]}
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "subphaser_torch/csrc/anchors.cu",
            "replaces": tpu_kernel_site("*_tpu/ops/anchors.py", needle),
            "launches": by_path["blocks"],
            "launches_by_path": by_path,
            **{key: row[key] for key in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                         "bound_ms", "bound_by", "library_ms",
                                         "share_of_bound", "shape")},
            **{key: row[key] for key in ("kernel_launches_a_call", "profiler_split_ms",
                                         "compact_list_bytes", "compact_list_ms",
                                         "sector_bound_ms")
               if key in row},
        })
    return entries


def stats_kernel_entry(res: dict) -> dict:
    """The kernels-line entry of fisher_right_tail (a hand-written kernel
    of an XLA-lowered function): its numbers are phase stats' on phase
    main's bin counts; it launches on no phasing path, so its launches are
    phase stats' calls of fisher_enrich_pvals."""
    from subphaser_torch.ops import stats

    st = res["stats"]
    st["launches_after"] = stats.launches["fisher_right_tail"]
    if st["launches_after"]:
        raise RuntimeError(f"fisher_right_tail launched on a phasing path after phase stats: "
                           f"{st['launches_after']}")
    row = st["main"]
    return {
        "name": "fisher_right_tail",
        "route": "cuda",
        "source": "subphaser_torch/csrc/stats.cu",
        "replaces": tpu_kernel_site("*_tpu/ops/stats.py", "def fisher_right_tail"),
        "launches": st["launches"],
        "launches_by_path": {"phases_before_stats": st["launches_before"]["fisher_right_tail"],
                             "stats": st["launches"],
                             "phases_after_stats": st["launches_after"]},
        "max_abs_err": max(st[n]["max_abs_err"] for n in ("main", "wheat_14gb")),
        **{key: row[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "share_of_bound", "max_rel_err", "shape",
                                     "terms", "sfu_ms", "fp32_ms", "bytes_ms", "walks",
                                     "bound_to_end", "chain", "share_of_chain_floor",
                                     "kernel_launches_a_call")},
        "wheat_14gb": st["wheat_14gb"],
    }


PARALLEL_INPUTS: dict = {}  # phase main's genome and options, for phase parallel


def check_range_slots(words, vwords, tile_bases: int, n_dev: int) -> dict:
    """range_slots on shard 0's local spectrum of ``words`` cut over
    ``n_dev`` shards (sharded_count's quota at slack 2): bit-exact against
    its plain version; its wrapper, device and plain ms and its bytes bound
    (the real entries read once, the slots and the flag written once)."""
    import torch

    from subphaser_torch.ops.kmer import SENTINEL
    from subphaser_torch.parallel import sharded_count as sc

    per = -(-words.shape[0] // n_dev)
    ucodes, ucounts = sc._local_spectrum(torch.from_numpy(words[:per]).cuda(),
                                         torch.from_numpy(vwords[:per]).cuda(), 15,
                                         tile_bases // 16)
    quota = int(per * tile_bases // n_dev * 2.0) + 16
    kw = dict(k=15, n_dev=n_dev, quota=quota)
    got = sc.range_slots(ucodes, ucounts, **kw)
    want = sc.range_slots_plain(ucodes, ucounts, **kw)
    torch.cuda.synchronize()
    err = max(int((g.long() - x.long()).abs().max()) for g, x in zip(got, want))
    if err:
        raise RuntimeError(f"range_slots differs from its plain version at D = {n_dev}: {err}")
    n_real = int((ucodes != SENTINEL).sum())
    res = {"n": ucodes.numel(), "n_real": n_real, "tiles": per, "n_dev": n_dev,
           "quota": quota, "overflow": int(got[2].item()), "max_abs_err": err}
    del got, want
    outs = [torch.empty((n_dev, quota), dtype=torch.int32, device="cuda") for _ in range(2)]
    flag = torch.empty(1, dtype=torch.int32, device="cuda")
    res["ms"] = time_ms(lambda: sc.range_slots(ucodes, ucounts, **kw))
    res["device_ms"] = queued_ms(lambda: sc.launch(
        "pl_range_slots", ucodes, ucounts, ucodes.numel(), n_dev, quota, 15, *outs, flag))
    res["plain_ms"] = time_ms(lambda: sc.range_slots_plain(ucodes, ucounts, **kw))
    res["bound_ms"] = bytes_ms(8 * n_real + 8 * n_dev * quota + 4)
    res["bound_by"] = "bytes"
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    return res


def check_candidate_counts(ucodes, ucounts, tile_chrom, cand, n_chrom: int,
                           ops_per_s: float) -> dict:
    """candidate_counts on one data shard's tile spectra and one kmer
    shard's candidates: bit-exact against its plain version (called on
    slices of the candidates, which bounds its memory); its wrapper, device
    and plain ms and its bound: the bytes this data needs (the candidates;
    a tile's code entry for each candidate and tile, at most the whole row;
    the count of each hit; the chromosomes; the output) against B x
    ceil(log2 N) compares a tile (operations)."""
    import math

    import torch

    from subphaser_torch import kernels
    from subphaser_torch.ops.kmer import SENTINEL
    from subphaser_torch.parallel import phase_step as ps
    from subphaser_torch.parallel import sharded_count as sc

    t, n = ucodes.shape
    chunk = max(1, (1 << 30) // (16 * t))

    def plain():
        return torch.cat([ps.candidate_counts_plain(ucodes, ucounts, tile_chrom,
                                                    cand[i:i + chunk], n_chrom)
                          for i in range(0, cand.numel(), chunk)])

    got = ps.candidate_counts(ucodes, ucounts, tile_chrom, cand, n_chrom)
    want = plain()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    kernels_a_call = kernels.graph_kernel_launches(
        lambda: ps.candidate_counts(ucodes, ucounts, tile_chrom, cand, n_chrom))
    if kernels_a_call != 2:
        raise RuntimeError(f"candidate_counts launched {kernels_a_call} kernels a call, not 2")
    if err:
        raise RuntimeError(f"candidate_counts differs from its plain version: {err}")
    hits = 0  # (tile, candidate) pairs where the tile holds the candidate
    for i in range(0, cand.numel(), chunk):
        c = cand[i:i + chunk]
        idx = torch.searchsorted(ucodes, c.expand(t, -1).contiguous()).clamp_max(n - 1)
        hits += int(((torch.gather(ucodes, 1, idx) == c) & (c != SENTINEL)
                     & (tile_chrom >= 0)[:, None]).sum())
    live = int((cand != SENTINEL).sum())
    res = {"tiles": t, "n": n, "candidates": cand.numel(), "chromosomes": n_chrom,
           "max_abs_err": err, "counted": int(got.long().sum()), "hits": hits,
           "kernel_launches_a_call": kernels_a_call}
    del got, want
    out = torch.empty((cand.numel(), n_chrom), dtype=torch.int32, device="cuda")
    scratch = torch.empty(sc.parallel_lib().pl_candidate_counts_scratch(cand.numel(), t),
                          dtype=torch.int64, device="cuda")

    def bare():
        sc.launch("pl_candidate_counts", ucodes, ucounts, n, tile_chrom, t, cand, cand.numel(),
                  n_chrom, scratch, out)
    res["ms"] = time_ms(lambda: ps.candidate_counts(ucodes, ucounts, tile_chrom, cand, n_chrom))
    res["device_ms"] = queued_ms(bare, calls=5)
    # the segments the count kernel stages (codes and counts), from the
    # bounds kernel's scratch: about every sector of them holds a hit
    seg = scratch.view(-1, t, 2)
    staged = int(((seg[..., 1] - seg[..., 0]) * (tile_chrom >= 0)[None, :]).sum())
    res.update(segment_entries=staged, segment_bytes_ms=bytes_ms(8 * staged))
    res["profiler_split_ms"] = {name: device_ms(lambda _x: bare(), None, name, required=False)
                                for name in ("cc_bounds_kernel", "cc_count_kernel")}
    res["plain_ms"] = time_ms(plain)
    byte_ms = bytes_ms(4 * t * min(n, live) + 4 * hits + 4 * cand.numel() + 4 * t
                       + 4 * cand.numel() * n_chrom)
    ops_ms = cand.numel() * math.ceil(math.log2(n)) * t / ops_per_s * 1e3
    res.update(bound_ms=max(byte_ms, ops_ms), bytes_ms=byte_ms, ops_ms=ops_ms,
               bound_by="bytes" if byte_ms >= ops_ms else "operations")
    res["share_of_bound"] = res["bound_ms"] / res["device_ms"]
    return res


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(mode: str, *args: str, env: dict | None = None, timeout: float = 600) -> list:
    """Two ranks of ``python chip_smoke.py --parallel-worker MODE ...`` in a
    gloo group on localhost: new interpreters, started after CUDA is up in
    this one. Returns [(returncode, output, seconds until it had exited,
    its WORKER record or None)] by rank."""
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-worker", mode,
         f"127.0.0.1:{port}", str(r), "2", *args],
        cwd=ROOT, env=dict(os.environ, **(env or {})), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    out = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=timeout)
            rec = [json.loads(line[len("WORKER "):]) for line in text.splitlines()
                   if line.startswith("WORKER ")]
            out.append((p.returncode, text, time.perf_counter() - t0, rec[0] if rec else None))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def parallel_worker(argv: list[str]) -> int:
    """One rank (``--parallel-worker MODE COORDINATOR RANK WORLD ...``): join
    the gloo group; ``run BASE ARGS``: run the CLI arguments ARGS as a
    Pipeline on cuda:<rank mod cards> with BASE/out_r<rank> and
    BASE/tmp_r<rank>, and print its WORKER record (wall and step seconds,
    exchanges); ``dead``: rank 1 leaves at once and rank 0 calls an
    exchange, which must exit 17."""
    import torch

    from subphaser_torch.parallel import distributed as pd

    mode, coordinator, rank, world, *rest = argv
    rank, world = int(rank), int(world)
    t0 = time.perf_counter()
    pd.init_distributed(coordinator, world, rank)
    if mode == "dead":
        if rank == 1:
            os._exit(0)
        print(f"EXCHANGE_START {time.time()}", flush=True)
        pd.exchange_blobs({rank: b"payload"}, world)
        print("exchange completed (unexpected)", flush=True)
        return 1
    from subphaser_torch import cli
    from subphaser_torch.phase.pipeline import Pipeline
    from subphaser_torch.utils.log import setup_logging

    setup_logging()
    base, *cli_args = rest
    kargs = dict(vars(cli.make_parser().parse_args(
        [*cli_args, "-o", os.path.join(base, f"out_r{rank}"),
         "-tmpdir", os.path.join(base, f"tmp_r{rank}")])))
    kargs["device"] = f"cuda:{rank % torch.cuda.device_count()}"
    pipe = Pipeline(kargs.pop("genomes"), kargs.pop("sg_cfgs"), labels=kargs.pop("labels"),
                    **kargs).run()
    torch.cuda.synchronize()
    print("WORKER " + json.dumps({
        "rank": rank, "device": kargs["device"], "wall_s": time.perf_counter() - t0,
        "step_s": {s: round(v, 3) for s, v in pipe.step_seconds.items()},
        "exchanges": pd.EXCHANGES, "prefix": os.path.basename(pipe.para_prefix)}), flush=True)
    torch.distributed.destroy_process_group()
    return 0


def data_files(d: str) -> list[str]:
    return sorted(f for f in os.listdir(d) if not f.endswith((".png", ".pdf")))


def check_rank_runs(name: str, runs: list, base: str, ref_out: str, ref_tmp: str | None,
                    markers: tuple) -> dict:
    """Both ranks ended with 0, every data file of each rank's outdir (and
    of tmp/Blocks with ``ref_tmp``) is the one-process run's bytes, and each
    marker is in both logs. Returns the ranks' records."""
    for rank, (rc, text, _s, rec) in enumerate(runs):
        if rc != 0 or rec is None:
            raise RuntimeError(f"{name}: rank {rank} exited {rc}:\n{text[-6000:]}")
        missing = [m for m in markers if m not in text]
        if missing:
            raise RuntimeError(f"{name}: rank {rank} logged no {missing}:\n{text[-4000:]}")
    want = data_files(ref_out)
    for rank in range(len(runs)):
        out = os.path.join(base, f"out_r{rank}")
        names = data_files(out)
        if ref_tmp is None:  # core phasing: phase main's six files
            prefix = runs[rank][3]["prefix"]
            names = [prefix + s for s in CORE_FILES]
        elif names != want:
            raise RuntimeError(f"{name}: rank {rank} wrote {names}, one process {want}")
        for f in names:
            if not same_bytes(os.path.join(out, f), os.path.join(ref_out, f)):
                raise RuntimeError(f"{name}: rank {rank}'s {f} differs from one process's")
        if ref_tmp is not None:
            got, one = (block_pafs(os.path.join(d)) for d in
                        (os.path.join(base, f"tmp_r{rank}"), ref_tmp))
            if list(got) != list(one) or not got:
                raise RuntimeError(f"{name}: rank {rank}'s PAFs {list(got)}, one process "
                                   f"{list(one)}")
            for f, path in got.items():
                if not same_bytes(path, one[f]):
                    raise RuntimeError(f"{name}: rank {rank}'s {f} differs from one process's")
    return {"files": len(names), "ranks": [
        {"rank": rec["rank"], "device": rec["device"], "wall_s": round(rec["wall_s"], 3),
         "step_s": rec["step_s"],
         "exchanges": [{"label": e["label"], "bytes": e["bytes"],
                        "seconds": round(e["seconds"], 4)} for e in rec["exchanges"]]}
        for _rc, _t, _s, rec in runs]}


def phase_parallel() -> dict:
    """Several devices and processes on the one card (see the module
    docstring, phase 12)."""
    import numpy as np
    import torch

    from subphaser_torch.config import group_indices
    from subphaser_torch.ops.count import merge_host
    from subphaser_torch.ops.filter import make_group_spec
    from subphaser_torch.ops import sort_smem
    from subphaser_torch.ops.kmer import SENTINEL
    from subphaser_torch.parallel import phase_step as ps
    from subphaser_torch.parallel import sharded_count as sc
    from subphaser_torch.parallel.mesh import make_mesh
    from subphaser_torch.phase.filtering import streaming_filter
    from subphaser_torch.phase.spectrum import build_matrix, count_genome
    from subphaser_torch.utils.checkpoint import Checkpoint

    main = PARALLEL_INPUTS
    if not main:
        raise RuntimeError("phase parallel needs phase main's run")
    genome, labels, tb = main["genome"], main["labels"], main["tile_bases"]
    npw = tb // 16
    ops_per_s, clock = card_int32_ops_per_s()
    torch.cuda.empty_cache()
    res = {"card": clock}
    spectra = count_genome(genome, 15, lower_count=main["lower_count"], tile_bases=tb,
                           checkpoint=Checkpoint(main["tmpdir"]), device="cuda")

    # 1. range_slots at A1's shapes; 2. sharded_spectrum of A1 on meshes of the card
    ci = labels.index("A1")
    tiles = [t for t in genome.tiles(15, tile_bases=tb) if t.chrom_index == ci]
    words = np.stack([t.words for t in tiles])
    vwords = np.stack([t.vwords for t in tiles])
    res["range_slots"] = {f"D={d}": check_range_slots(words, vwords, tb, d) for d in (2, 4)}
    del words, vwords
    torch.cuda.empty_cache()
    want = spectra[ci]
    res["sharded_spectrum"] = {}
    for name in sc.launches:
        sc.launches[name] = 0
    reset_sort_launches()
    for n_dev in (2, 4):
        t0 = time.perf_counter()
        codes, counts = sc.sharded_spectrum(make_mesh(n_dev, 1, devices=["cuda:0"] * n_dev),
                                            tiles, 15, npw)
        seconds = time.perf_counter() - t0
        keep = counts >= main["lower_count"]
        if not (np.array_equal(codes[keep], want.codes)
                and np.array_equal(counts[keep], want.counts)):
            raise RuntimeError(f"sharded_spectrum on {n_dev} shards differs from phase main's "
                               f"spectrum of A1")
        res["sharded_spectrum"][f"({n_dev}, 1)"] = {"seconds": round(seconds, 3),
                                                    "distinct": int(codes.size),
                                                    "kept": int(keep.sum())}
    res["range_slots_launches"] = sc.launches["range_slots"]
    res["sort_launches"] = {"sharded_spectrum": dict(sort_smem.route_launches)}
    torch.cuda.empty_cache()

    # 3. the fused step on meshes (2, 1) and (2, 2) of the card over every
    # tile. It counts every occurrence (the JAX step applies no dump
    # threshold), so its reference is the host filter over spectra counted
    # with lower_count 1, whose totals also give the chromosome lengths.
    del spectra
    spectra = count_genome(genome, 15, lower_count=1, tile_bases=tb, device="cuda")
    all_codes, tot = merge_host([(s.codes, s.counts) for s in spectra])
    min_freq = main["min_freq"]
    cand = all_codes[(tot >= min_freq) & (tot <= 1e9)].astype(np.int32)
    lengths = np.array([s.total for s in spectra], dtype=np.float32)
    spec = make_group_spec(group_indices(main["sgs"], labels), len(labels))
    host = streaming_filter(spectra, spec, min_freq=min_freq, max_freq=1e9, min_fold=2.0,
                            want_histogram=False).matrix
    exact = build_matrix(spectra, min_freq, 1e9)  # every candidate's counts, host int64 path
    if not np.array_equal(exact.codes, cand):
        raise RuntimeError("the candidate table differs from build_matrix's")
    tiles = list(genome.tiles(15, tile_bases=tb))
    words = np.stack([t.words for t in tiles])
    vwords = np.stack([t.vwords for t in tiles])
    onehot = np.zeros((len(tiles), len(labels)), dtype=np.float32)
    onehot[np.arange(len(tiles)), [t.chrom_index for t in tiles]] = 1.0
    args = (words, vwords, onehot, cand, lengths, spec.member, spec.set_groups,
            spec.set_ncols, np.asarray(spec.set_valid), np.argsort(labels).astype(np.int32))
    assign = read_assignments(main["prefix"])
    res["phase_step"] = {"candidates": int(cand.size), "differential": int(host.codes.size)}
    for name in ps.launches:
        ps.launches[name] = 0
    reset_sort_launches()
    for shape in ((2, 1), (2, 2)):
        mesh = make_mesh(*shape, devices=["cuda:0"] * (shape[0] * shape[1]))
        step = ps.build_phase_step(mesh, k=15, n_pos_words=npw, n_clusters=main["nsg"],
                                   min_freq=min_freq, max_freq=1e9, min_fold=2.0)
        sharded = ps.shard_inputs(mesh, *args)
        t0 = time.perf_counter()
        out, counts, diff = step(*sharded, torch.Generator().manual_seed(0))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out, counts, diff = out.cpu().numpy(), counts.cpu().numpy(), diff.cpu().numpy()
        padded = sharded[3].numpy()
        valid = padded != SENTINEL
        idx = np.searchsorted(host.codes, padded[valid])
        idx_c = np.minimum(idx, host.codes.size - 1)
        isdiff = (idx < host.codes.size) & (host.codes[idx_c] == padded[valid])
        ties = fold_ties(counts[valid], lengths, spec, 2.0)
        if not (np.array_equal(counts[valid], exact.counts) and not diff[~valid].any()
                and np.array_equal(diff[valid][~ties], isdiff[~ties])):
            raise RuntimeError(f"phase_step on {shape}: diff or counts differ from the host "
                               f"filter's matrix")
        pairs = {(int(lab), assign[c][0]) for c, lab in zip(labels, out)}
        if len(pairs) != len({p[0] for p in pairs}) or len(pairs) != len({p[1] for p in pairs}):
            raise RuntimeError(f"phase_step on {shape}: labels {dict(zip(labels, out))} are not "
                               f"phase main's assignments {assign}")
        res["phase_step"][str(shape)] = {
            "seconds": round(seconds, 3), "labels": dict(zip(labels, out.tolist())),
            "differential": int(diff.sum()), "fold_ties": int(ties.sum()),
            "ties_flagged_by_step_not_host": int((diff[valid] & ~isdiff & ties).sum()),
            "ties_flagged_by_host_not_step": int((~diff[valid] & isdiff & ties).sum())}
        del sharded, out, counts, diff
        torch.cuda.empty_cache()
    res["candidate_counts_launches"] = ps.launches["candidate_counts"]
    res["sort_launches"]["phase_step"] = dict(sort_smem.route_launches)
    if not (res["range_slots_launches"] and res["candidate_counts_launches"]
            and all(n["radix"] for n in res["sort_launches"].values())):
        raise RuntimeError(f"a kernel did not launch on its path: "
                           f"{res['range_slots_launches']}, {res['candidate_counts_launches']}, "
                           f"{res['sort_launches']}")

    # 1, candidate_counts at the step's shapes: data shard 0's tiles against
    # the whole table (mesh (2, 1)) and against kmer shard 0 (mesh (2, 2))
    per = -(-len(tiles) // 2)
    ucodes, ucounts = ps.tile_spectra(torch.from_numpy(words[:per]).cuda(),
                                      torch.from_numpy(vwords[:per]).cuda(), 15, npw)
    tile_chrom = torch.tensor([t.chrom_index for t in tiles[:per]], dtype=torch.int32,
                              device="cuda")
    cand_d = torch.from_numpy(cand).cuda()
    res["candidate_counts"] = {}
    for shape, part in (("(2, 1)", cand_d), ("(2, 2)", cand_d[: -(-cand.size // 2)])):
        res["candidate_counts"][shape] = check_candidate_counts(
            ucodes, ucounts, tile_chrom, part, len(labels), ops_per_s)
    del ucodes, ucounts, cand_d, words, vwords
    torch.cuda.empty_cache()

    # 4. two processes on the card; 5. a dead rank
    res["ranks"] = parallel_ranks()
    t_start = time.time()
    runs = run_ranks("dead", env={"SUBPHASER_COLLECTIVE_TIMEOUT": "10"}, timeout=120)
    (rc0, text0, _s0, _r0), _rank1 = runs
    starts = [float(line.split()[1]) for line in text0.splitlines()
              if line.startswith("EXCHANGE_START ")]
    if rc0 != 17 or "Exiting 17" not in text0 or not starts:
        raise RuntimeError(f"dead rank: the survivor exited {rc0}, not 17:\n{text0[-3000:]}")
    res["dead_rank"] = {"survivor_rc": rc0,
                        "exit_s_after_exchange_start": round(t_start + runs[0][2] - starts[0], 3),
                        "message": next(line for line in text0.splitlines()
                                        if "Exiting 17" in line)[-240:]}
    if res["dead_rank"]["exit_s_after_exchange_start"] > 10:
        raise RuntimeError(f"dead rank: the survivor took {res['dead_rank']} to exit")
    log("parallel " + json.dumps(res))
    log(f"phase parallel ok: range_slots and candidate_counts bit-exact at the 480 Mb shapes; "
        f"sharded_spectrum on 2 and 4 shards = phase main's A1 spectrum; phase_step on (2, 1) "
        f"and (2, 2) = the host filter's matrix and phase main's assignments; two ranks wrote "
        f"one process's files; a dead rank's survivor exited 17")
    return res


def fold_ties(counts, lengths, spec, min_fold: float):
    """Rows whose float64 fold ratio top / base in some valid homoeologous
    set lies within 1e-6 of ``min_fold`` (baseline 1). There the fused
    step's float32 gate (frequencies per Mb, its 1e-20 guard lost) and the
    host filter's float64 gate (frequencies per base, the guard 1e-14 of
    them) can decide differently: an exact tie passes the step and fails
    the host, in the JAX package's step as in the port's."""
    import numpy as np

    member = spec.member.astype(np.float64)
    gfreq = (counts.astype(np.float64) @ member.T) / (member @ lengths.astype(np.float64))
    pad = spec.set_groups < 0
    gathered = np.where(pad[None], -np.inf, gfreq[:, np.clip(spec.set_groups, 0, None)])
    desc = -np.sort(-gathered, axis=-1)
    top, base = desc[..., 0], desc[..., min(1, spec.set_groups.shape[1] - 1)]
    near = np.abs(top - min_fold * base) <= 1e-6 * np.abs(top)
    return (near & spec.set_valid[None, :]).any(axis=1)


def parallel_ranks() -> dict:
    """Two processes on the one card over gloo: core phasing at 480 Mb with
    phase main's options (each rank's six core files must be phase main's
    bytes), and the default run of phase parity's 12 Mb genome (every data
    file and PAF of each rank must be the one-process default run's bytes);
    every stage's marker must be in both ranks' logs."""
    fa, cfg, _hmm = main_genome()
    sfa, scfg, shmm = gen_genome(os.path.join(WORK, "small"), 2, 2)
    parity = os.path.join(WORK, "small", "cuda_default")
    main = PARALLEL_INPUTS
    res = {}
    for name, args, ref_out, ref_tmp, markers in (
            ("core_480mb", ["-i", fa, "-c", cfg, "-k", "15", "-min_freq", str(main["min_freq"]),
                            "-lower_count", str(main["lower_count"]), "-tile_bases",
                            str(main["tile_bases"]), "-replicates", str(main["replicates"]),
                            "-disable_ltr", "-disable_circos", "-disable_blocks"],
             os.path.join(WORK, "main", "out"), None,
             ("Distributed counting", "Sharded mapping: rank")),
            ("default_12mb", ["-i", sfa, "-c", scfg, "-k", "15", "-min_freq", "4",
                              "-lower_count", "2", "-tile_bases", str(1 << 20), "-replicates",
                              "100", "-hmm_db", shmm],
             os.path.join(parity, "out"), os.path.join(parity, "tmp"),
             ("Distributed counting", "Sharded mapping: rank", "Sharded LTR detection",
              "Sharded classification", "Sharded blocks"))):
        base = os.path.join(WORK, f"ranks_{name}")
        shutil.rmtree(base, ignore_errors=True)  # fresh tmpdirs: every step runs sharded
        t0 = time.perf_counter()
        runs = run_ranks("run", base, *args)
        res[name] = check_rank_runs(name, runs, base, ref_out, ref_tmp, markers)
        res[name]["wall_s"] = round(time.perf_counter() - t0, 3)
    return res


def parallel_kernel_entries(res: dict) -> list[dict]:
    """The kernels-line entries of range_slots and candidate_counts
    (hand-written kernels of XLA-lowered programs): their numbers are phase
    parallel's at the 480 Mb shapes (range_slots: A1 at D = 2; candidate
    counts: mesh (2, 1)), their launches those of the paths driven there
    (sharded_spectrum on 2 and 4 shards; phase_step on (2, 1) and (2, 2))."""
    par = res["parallel"]
    out = []
    for name, lead_key, by_shape, launches, site in (
            ("range_slots", "D=2", par["range_slots"], par["range_slots_launches"],
             ("*_tpu/parallel/sharded_count.py", "def _local_count_and_exchange")),
            ("candidate_counts", "(2, 1)", par["candidate_counts"],
             par["candidate_counts_launches"],
             ("*_tpu/parallel/phase_step.py", "def _tile_candidate_counts"))):
        lead = by_shape[lead_key]
        out.append({
            "name": name,
            "route": "cuda",
            "source": "subphaser_torch/csrc/parallel.cu",
            "replaces": tpu_kernel_site(*site),
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in by_shape.values()),
            **{key: lead[key] for key in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                          "share_of_bound")},
            **{key: lead[key] for key in ("kernel_launches_a_call", "profiler_split_ms")
               if key in lead},
            "library_ms": None,
            "by_shape": by_shape,
        })
    return out


PHASES = ["build", "sort", "runs", "primitives", "hmm", "parity", "main", "stats", "main_k17",
          "ltr", "trees", "blocks", "anchors", "parallel"]


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
    res = {}
    t_all = time.perf_counter()
    try:
        for name in PHASES:
            t0 = time.perf_counter()
            if name.startswith("main"):
                res[name] = phase_main(17 if name == "main_k17" else 15)
            else:
                res[name] = globals()[f"phase_{name}"]()
            log(f"phase {name} took {time.perf_counter() - t0:.1f} s "
                f"({time.perf_counter() - t_all:.1f} s in all)")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    log(smi)
    sort_rows, (prim_rows, prim_launches) = res["sort"], res["primitives"]
    main_res, k17_res = res["main"], res["main_k17"]
    by_path = {route: {"main": main_res["sort_launches_by_route"][route],
                       "main_k17": k17_res["sort_launches_by_route"][route],
                       **{f"parallel_{p}": n[route]
                          for p, n in res["parallel"]["sort_launches"].items()}}
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
            "bound_by": lead["bound_by"],
            "library_ms": lead.get("library_ms"),
            "candidates": cands,
        })
        if name in WARP_ENTRIES:  # the kernel alone, and the sizes checked
            kernels[-1].update({key: lead[key] for key in
                                ("device_ms", "share_of_bound", "by_size")})
            kernels[-1]["max_abs_err"] = max(
                [kernels[-1]["max_abs_err"]]
                + [r["max_abs_err"] for r in lead["by_size"].values()])
    unrolled = next(k for k in kernels if k["name"] == "block_sort_unrolled")
    unrolled["block_sort_ms"] = prim_rows["block_sort"]["ms"]  # the looped twin
    unrolled["network_ops_ms"] = prim_rows["block_sort_unrolled"]["network_ops_ms"]
    # the classifier's scans (hand-written kernels of XLA-lowered functions);
    # their own numbers are the wheat fixture database at L = 1024, a bucket
    # of the ltr path
    for name, needle in (("viterbi_scan", "def _viterbi_scan_batch"),
                         ("ssv_scan", "def _ssv_scan_batch")):
        by_shape = res["hmm"][name]
        lead = next(r for key, r in by_shape.items() if key.startswith("wheat")
                    and key.endswith("B=1024 L=1024"))
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "subphaser_torch/csrc/hmm_scan.cu",
            "replaces": tpu_kernel_site("*/ltr/classify.py", needle),
            "launches": res["ltr"]["launches"][name],
            "launches_by_route": res["ltr"]["launches_by_route"][name],
            "max_abs_err": max(r["max_abs_err"] for r in by_shape.values()),
            "ms": lead["ms"],
            "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"],
            "bound_by": lead["bound_by"],
            "library_ms": None,
            "by_shape": by_shape,
        })
    lead = res["runs"]["batch_2^24"]
    kernels.append({
        "name": "runs",
        "route": "cuda",
        "source": "subphaser_torch/csrc/runs.cu",
        # a hand-written kernel of an XLA-lowered function (jax.lax.cummax)
        "replaces": tpu_kernel_site("*/ops/count.py", "def _sorted_run_survivors"),
        "launches": main_res["run_launches"],
        "launches_by_path": {"main": main_res["run_launches"],
                             "main_k17": k17_res["run_launches"]},
        "max_abs_err": max(r["max_abs_err"] for r in res["runs"].values()),
        **{key: lead[key] for key in ("kernel_ms", "count_ms", "plain_ms", "cummax_ms",
                                      "bound_ms", "share_of_bound")},
        "bound_by": "bytes",
        "library_ms": None,
        "by_shape": res["runs"],
    })
    kernels += tree_kernel_entries(res)
    kernels += anchor_kernel_entries(res)
    kernels.append(stats_kernel_entry(res))
    kernels += parallel_kernel_entries(res)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(sys.argv[2:]))
    sys.exit(main())
