"""One run of one cell: set-up, the measured window of whole jobs, the
check against the plain reference, and the metrics.

A job is one ``subphaser_torch.cli.main`` call, in this process, on the
cell's genome with the cell's options, into a fresh output and temporary
directory under ``TMPDIR`` that is deleted after it: one user's queue of
assemblies, each run as upstream runs one. Jobs start while less than
``seconds`` have passed since the window opened, one at a time; the window
closes when the last one ends.

Everything that belongs to one configuration, traffic mix or metric is data
or a file of its own: ``BENCHMARK.json`` names the cell, the cell names its
configuration's file and its mix, ``traffic/<mix>.json`` holds the job
options, and ``metrics/<name>.py`` reads each metric from a :class:`Run`.
"""

from __future__ import annotations

import gc
import glob
import hashlib
import importlib.util
import json
import logging
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

from perfbench import compare, genome, tracing

PKG = os.path.dirname(os.path.abspath(__file__))
GENOME_CACHE_KEEP = 6  # genomes kept per configuration in the cache


@dataclass
class Job:
    seconds: float
    bases: int
    step_seconds: dict
    bytes_written: int       # the files the job left in its directories
    files_key: str | None   # digest of the five core files; None if the job failed
    traced: bool = False
    error: str | None = None
    host: dict = field(default_factory=dict)  # host_sample()'s deltas over the job


@dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    window_s: float
    jobs: list
    peak_bytes: int
    sort_launches: int                # sort_smem.launches over the window
    trace: tracing.TraceSummary | None = None
    trace_sort_launches: int = 0      # sort_smem.launches during the traced job
    extra: dict = field(default_factory=dict)

    @property
    def done(self) -> list:
        return [j for j in self.jobs if j.files_key is not None]

    def step_mean(self, step: str) -> float | None:
        """Mean seconds of ``step`` over the window's untraced jobs (the
        traced one where it is alone)."""
        jobs = [j for j in self.done if not j.traced] or self.done
        vals = [j.step_seconds[step] for j in jobs if step in j.step_seconds]
        return sum(vals) / len(vals) if vals else None

    @property
    def trace_whole(self) -> bool:
        """Whether the trace holds a launch in every sort the program counted."""
        t = self.trace
        return (t is not None and t.sort_spans == self.trace_sort_launches
                and t.sort_spans_launched == t.sort_spans)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(root: str, workload: str) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the workload, its configuration file, its traffic)."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    (cell,) = [w for w in bench["workloads"] if w["name"] == workload]
    (cfg_entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    cfg = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic", cell["traffic"] + ".json"))
    return bench, cell, cfg, traffic


def cell_metrics(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics the cell reports in this mode."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = os.path.join(PKG, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cached_genome(root: str, cfg: dict, seed: int) -> tuple[str, str]:
    """The configuration's genome for ``seed``, generated once per checkout
    into ``perfbench/_cache/genomes/<config>-<seed>/``; older seeds beyond
    GENOME_CACHE_KEEP are removed."""
    base = os.path.join(root, "perfbench", "_cache", "genomes")
    final = os.path.join(base, f"{cfg['name']}-{seed}")
    fa, sgc = os.path.join(final, "genome.fa"), os.path.join(final, "sg.config")
    if os.path.exists(os.path.join(final, "done")):
        os.utime(final)
        return fa, sgc
    stage = f"{final}.partial"
    shutil.rmtree(stage, ignore_errors=True)
    genome.generate(stage, seed, cfg["subgenomes"], cfg["n_sets"], cfg["chrom_bases"],
                    cfg.get("shared_families", genome.SHARED_FAMILIES),
                    cfg.get("sg_families", genome.SG_FAMILIES))
    open(os.path.join(stage, "done"), "w").close()
    shutil.rmtree(final, ignore_errors=True)
    os.replace(stage, final)
    old = sorted((p for p in glob.glob(os.path.join(base, cfg["name"] + "-*"))
                  if os.path.isdir(p) and not p.endswith(".partial") and p != final),
                 key=os.path.getmtime)
    for p in old[:max(0, len(old) - (GENOME_CACHE_KEEP - 1))]:
        shutil.rmtree(p, ignore_errors=True)
    return fa, sgc


def job_argv(fa: str, sgc: str, out: str, tmp: str, cfg: dict, traffic: dict,
             device: str) -> list[str]:
    return (["-i", fa, "-c", sgc, "-o", out, "-tmpdir", tmp] + list(cfg["options"])
            + list(traffic["options"]) + ["-device", device])


def read_core_files(outdir: str) -> dict[str, str | None]:
    files = {}
    for suffix in compare.FILES:
        paths = glob.glob(os.path.join(outdir, "*." + suffix))
        files[suffix] = open(paths[0]).read() if len(paths) == 1 else None
    return files


def host_sample() -> dict:
    """Counters read at a job's ends, to tell what slows a job down: the
    process's CPU seconds (every thread), the machine's CPU seconds stolen
    by the hypervisor and idle on I/O, the seconds some task stalled on CPU
    or I/O (pressure stall information, where the kernel has it), and the
    bytes this process sent to storage or cancelled by deleting them."""
    s = {"cpu_s": time.process_time()}
    try:
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        hz = os.sysconf("SC_CLK_TCK")
        s["iowait_s"], s["steal_s"] = int(cpu[5]) / hz, int(cpu[8]) / hz
    except (OSError, ValueError, IndexError):
        pass
    for kind in ("cpu", "io"):
        try:
            with open(f"/proc/pressure/{kind}") as f:
                for line in f:
                    words = line.split()
                    s[f"psi_{kind}_{words[0]}_s"] = int(words[-1].split("=")[1]) / 1e6
        except (OSError, ValueError, IndexError):
            pass
    try:
        with open("/proc/self/io") as f:
            for line in f:
                key, _, val = line.partition(":")
                if key in ("write_bytes", "cancelled_write_bytes"):
                    s[key] = int(val)
    except (OSError, ValueError):
        pass
    return s


def host_delta(before: dict, after: dict) -> dict:
    d = {k: after[k] - before[k] for k in after if k in before}
    d["load1"] = os.getloadavg()[0]
    return d


def run_job(argv_of, bases: int, outputs: dict, trace_dir: str | None = None) -> Job:
    """One job in a fresh directory under TMPDIR; its core files are kept
    in ``outputs`` by digest."""
    from subphaser_torch import cli

    work = tempfile.mkdtemp(prefix="perfbench-job-")
    argv = argv_of(os.path.join(work, "out"), os.path.join(work, "tmp"))
    if trace_dir:
        argv += ["-trace", trace_dir]
    host0 = host_sample()
    t0 = time.perf_counter()
    try:
        pipe = cli.main(argv)
        steps = dict(pipe.step_seconds)
        del pipe
        files = read_core_files(os.path.join(work, "out"))
        error = None
    except Exception as e:  # a failed job counts as failed, the run goes on
        steps, files, error = {}, None, f"{type(e).__name__}: {e}"
    seconds = time.perf_counter() - t0
    written = sum(os.path.getsize(os.path.join(d, f))
                  for d, _, fs in os.walk(work) for f in fs)
    shutil.rmtree(work, ignore_errors=True)
    host = host_delta(host0, host_sample())
    key = None
    if files is not None:
        key = hashlib.sha256(json.dumps(files, sort_keys=True).encode()).hexdigest()
        outputs.setdefault(key, files)
    return Job(seconds=seconds, bases=bases, step_seconds=steps, bytes_written=written,
               files_key=key, traced=trace_dir is not None, error=error, host=host)


GPU_QUERY = "clocks.sm,clocks.mem,temperature.gpu,power.draw,clocks_throttle_reasons.active"


def gpu_sample() -> dict | None:
    """The card's clocks, temperature, power and throttle reasons, read by
    ``nvidia-smi`` outside the window (None where it gives nothing)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={GPU_QUERY}",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    vals = [v.strip() for v in out.strip().split(",")]
    return dict(zip(GPU_QUERY.split(","), vals)) if len(vals) == 5 else None


def _patch_sort_spans():
    """Wraps every binding of ``sort_int32_pow2`` in the program's modules
    with a profiler span that carries its key count (CUDA tensors only)."""
    import sys

    import torch

    import subphaser_torch.phase.pipeline  # noqa: F401  (imports every caller)
    from subphaser_torch.ops import sort_smem

    orig = sort_smem.sort_int32_pow2

    def sort_int32_pow2(x):
        if x.device.type != "cuda":
            return orig(x)
        with torch.profiler.record_function(f"{tracing.SORT_SPAN}{x.numel()}"):
            return orig(x)

    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] == "subphaser_torch" and getattr(mod, "sort_int32_pow2", None) is orig:
            mod.sort_int32_pow2 = sort_int32_pow2


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None) -> dict:
    """One run; returns the result line's fields and the compared numbers."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, cfg, traffic = cell_spec(root, workload)
    from subphaser_torch import kernels
    from subphaser_torch.ops import sort_smem
    from subphaser_torch.utils.log import logger

    if not logger.handlers:  # the program's step logs stay out of the run's output
        quiet = logging.StreamHandler()
        quiet.setLevel(logging.WARNING)
        logger.addHandler(quiet)
    on_card = device == "cuda"
    built = kernels.build() if on_card else {}
    if trace:
        _patch_sort_spans()
    fa, sgc = cached_genome(root, cfg, seed)
    bases = genome.total_bases(cfg["subgenomes"], cfg["n_sets"], cfg["chrom_bases"])

    def argv_of(out, tmp):
        return job_argv(fa, sgc, out, tmp, cfg, traffic, device)

    outputs: dict[str, dict] = {}
    warm = run_job(argv_of, bases, outputs)
    if warm.error:
        raise RuntimeError(f"the warm-up job failed: {warm.error}")
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    # the window: one job at a time, the first traced where asked
    jobs: list[Job] = []
    launches0 = sort_smem.launches
    trace_dir = tempfile.mkdtemp(prefix="perfbench-trace-") if trace else None
    trace_launches = 0  # sort_smem.launches during the traced job
    gpu_before = gpu_sample() if on_card else None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        traced = trace_dir is not None and not jobs
        before = sort_smem.launches
        jobs.append(run_job(argv_of, bases, outputs, trace_dir if traced else None))
        if traced:
            trace_launches = sort_smem.launches - before
    window_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.synchronize()
    gpu_after = gpu_sample() if on_card else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary = None
    if trace_dir:
        summary = tracing.summarize(tracing.load_dir(trace_dir))
        shutil.rmtree(trace_dir, ignore_errors=True)
    run = Run(setup_s=setup_s, window_s=window_s, jobs=jobs, peak_bytes=peak,
              sort_launches=sort_smem.launches - launches0, trace=summary,
              trace_sort_launches=trace_launches,
              extra={"kernels_built": sorted(built), "gpu_before": gpu_before,
                     "gpu_after": gpu_after})
    if summary is not None:  # for the run's diagnostic line
        run.extra.update(trace_sort_spans=summary.sort_spans,
                         trace_sort_spans_launched=summary.sort_spans_launched,
                         trace_sort_keys=summary.sort_keys,
                         trace_sort_device_s=summary.sort_device_s,
                         traced_job_sort_launches=run.trace_sort_launches)

    # the check, once the program's state is freed
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    from perfbench import reference

    opts = reference.Options.from_argv(argv_of("out", "tmp"))
    t_ref = time.perf_counter()
    ref = reference.core_files(fa, sgc, opts, device=device)
    run.extra["reference_s"] = time.perf_counter() - t_ref
    run.extra["kmer_mat_rows"] = len(ref["kmer.mat"]) - 1
    run.extra["sig_kmers"] = len(ref["sig.kmer-subgenome.tsv"]) - 1
    per_key = {key: compare.compare(files, ref) for key, files in outputs.items()}
    window_keys = {j.files_key for j in jobs if j.files_key}
    numbers = {name: max((per_key[k][name] for k in window_keys), default=0)
               for name in compare.LIMITS}
    failed = sum(1 for j in jobs
                 if j.files_key is None or not compare.verdict(per_key[j.files_key]))
    correct = bool(jobs) and failed == 0

    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    errors = sorted({j.error for j in jobs if j.error})
    return {"correct": correct, "attempted": len(jobs), "failed": failed,
            "metrics": metrics, "run": run, "numbers": numbers, "errors": errors}
