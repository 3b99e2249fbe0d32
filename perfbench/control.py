"""The control of the check that decides ``correct``: the plain reference
computed in float32 (the configuration states float64) put in the
program's place, at a cell's own size, on the given seeds. Each seed prints
one JSON line with the numbers the harness compares; the control has to
fail at least one of them.

    python3 perfbench/control.py --workload <name> --seeds 1 2 3 [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import compare, harness, reference  # noqa: E402


def control_numbers(root: str, workload: str, seed: int, device: str) -> dict:
    _bench, _cell, cfg, traffic = harness.cell_spec(root, workload)
    fa, sgc = harness.cached_genome(root, cfg, seed)
    opts = reference.Options.from_argv(
        harness.job_argv(fa, sgc, "out", "tmp", cfg, traffic, device))
    t0 = time.perf_counter()
    ref = reference.core_files(fa, sgc, opts, device=device)
    t1 = time.perf_counter()
    low = reference.core_files(fa, sgc, opts, device=device, precision="float32")
    files = {suffix: "\n".join(lines) + "\n" for suffix, lines in low.items()}
    # the bootstrap column the reference does not compute: a sound value
    files["chrom-subgenome.tsv"] = "\n".join(
        line if i == 0 else line + "\t100"
        for i, line in enumerate(low["chrom-subgenome.tsv"])) + "\n"
    numbers = compare.compare(files, ref)
    ref_kmers = {line.split("\t", 1)[0] for line in ref["kmer.mat"][1:]}
    low_kmers = {line.split("\t", 1)[0] for line in low["kmer.mat"][1:]}
    return {"workload": workload, "seed": seed, "numbers": numbers,
            "correct": compare.verdict(numbers),
            "kmer_rows_gate_flipped": len(ref_kmers ^ low_kmers),
            "kmer_rows": len(ref_kmers), "reference_s": t1 - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_numbers(ROOT, args.workload, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
