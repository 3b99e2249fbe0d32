"""Summarize a feature-enrichment TSV by annotation class x subgenome
(reference stat_enrich.py:1-41: feature ids like 'Gypsy-...' are grouped by
the prefix before '-', counting enriched features and summing count vectors).

CLI: ``python -m subphaser_torch.phase.stat_enrich input.enrich > summary.tsv``
"""

from __future__ import annotations

import sys

import numpy as np


def stat_enrich(in_tsv: str, fout=sys.stdout) -> None:
    d_count: dict[tuple, list] = {}
    anns, sgs = set(), set()
    with open(in_tsv) as f:
        for line in f:
            if line.startswith("#"):
                continue
            t = line.strip().split()
            if len(t) < 4:
                continue
            fid, sg, _pval, counts = t[:4]
            ann = fid.split("-")[0]
            vec = np.array([int(x) for x in counts.split(",")])
            key = (ann, sg)
            if key not in d_count:
                d_count[key] = [1, vec]
            else:
                d_count[key][0] += 1
                d_count[key][1] = d_count[key][1] + vec
            anns.add(ann)
            sgs.add(sg)
    for ann in sorted(anns):
        nums, total = [], None
        for sg in sorted(sgs):
            n, vec = d_count.get((ann, sg), (0, None))
            nums.append(n)
            if vec is not None:
                total = vec if total is None else total + vec
        if total is None:
            total = np.zeros(len(sgs), dtype=int)
        fout.write("\t".join(map(str, [ann] + nums + list(total))) + "\n")


if __name__ == "__main__":
    stat_enrich(sys.argv[1])
