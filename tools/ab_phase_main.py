"""Run the 480 Mb main path of two checkouts in turns on one CUDA card.

Each checkout's own ``chip_smoke.phase_main()`` runs in a process of its
own, in the order parent, change, change, parent, so that both sides meet
the same card, power limit and host inside one call. The first run of each
side includes its kernel build. Prints the card's name and power limit,
then one JSON line per run (wall and step seconds, sort launches, peak
device memory).

Usage: python tools/ab_phase_main.py PARENT_CHECKOUT CHANGE_CHECKOUT
"""

from __future__ import annotations

import os
import subprocess
import sys

CODE = (
    "import json, shutil, chip_smoke as cs\n"
    "r = cs.phase_main()\n"
    "shutil.rmtree(cs.WORK, ignore_errors=True)\n"
    "keys = ('wall_s', 'step_s', 'sort_launches', 'max_memory_allocated_bytes')\n"
    "print('AB ' + json.dumps({k: r[k] for k in keys}))\n"
)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"parent": os.path.abspath(args[0]), "change": os.path.abspath(args[1])}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    failed = 0
    for side in ("parent", "change", "change", "parent"):
        res = subprocess.run([sys.executable, "-c", CODE], cwd=trees[side],
                             capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode != 0 or not lines:
            failed += 1
            print(side, "FAILED", res.stderr[-2000:], flush=True)
        else:
            print(side, lines[0][3:], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
