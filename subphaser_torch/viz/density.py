"""Generic windowed density tools (reference Circos.py:16-234, 844-1016).

Standalone utilities computing per-window densities from common annotation
formats — gene density from GFF3, repeat density from RepeatMasker .out,
variant density from VCF, GC fraction from FASTA — written as
``chrom start end value`` files (circos-track style) usable as custom
features or plotted directly.

CLI: ``python -m subphaser_torch.viz.density <gene|repeat|variant|gc|bed>
INPUT OUTPUT [window_size]``
"""

from __future__ import annotations

import sys
from collections import OrderedDict

import numpy as np

from subphaser_torch.io.fasta import iter_fasta, xopen


def _add(d, chrom, b, val=1):
    d.setdefault(chrom, {})
    d[chrom][b] = d[chrom].get(b, 0) + val


def write_density(d_count: dict, outfile: str, window_size: int) -> None:
    with open(outfile, "w") as f:
        for chrom, bins in d_count.items():
            for b, count in sorted(bins.items()):
                start = b * window_size
                f.write(f"{chrom} {start} {start + window_size} {count}\n")


def bed_density(path: str, window_size: int = 1_000_000, by_sites: bool = False):
    d: OrderedDict = OrderedDict()
    with xopen(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            t = line.split()
            if len(t) < 2:
                continue
            try:
                chrom, start = t[0], int(t[1])
                end = int(t[2]) if len(t) > 2 else start + 1
            except ValueError:
                continue
            if by_sites:
                for b in range(start // window_size, (end - 1) // window_size + 1):
                    lo = max(start, b * window_size)
                    hi = min(end, (b + 1) * window_size)
                    _add(d, chrom, b, hi - lo)
            else:
                _add(d, chrom, start // window_size)
    return d


def gene_density(gff3: str, window_size: int = 1_000_000, feature: str = "gene"):
    d: OrderedDict = OrderedDict()
    with xopen(gff3, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            t = line.rstrip("\n").split("\t")
            if len(t) < 5 or t[2] != feature:
                continue
            _add(d, t[0], int(t[3]) // window_size)
    return d


def repeat_density(rm_out: str, window_size: int = 1_000_000, by_sites: bool = True):
    """RepeatMasker .out: columns 5/6/7 are chrom/begin/end (1-based)."""
    d: OrderedDict = OrderedDict()
    with xopen(rm_out, "rt") as f:
        for line in f:
            t = line.split()
            if len(t) < 7 or not t[0].isdigit():
                continue
            chrom, start, end = t[4], int(t[5]) - 1, int(t[6])
            if by_sites:
                for b in range(start // window_size, (end - 1) // window_size + 1):
                    lo = max(start, b * window_size)
                    hi = min(end, (b + 1) * window_size)
                    _add(d, chrom, b, hi - lo)
            else:
                _add(d, chrom, start // window_size)
    return d


def variant_density(vcf: str, window_size: int = 1_000_000, het_only: bool = False):
    d: OrderedDict = OrderedDict()
    with xopen(vcf, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            t = line.rstrip("\n").split("\t")
            if len(t) < 2:
                continue
            if het_only and len(t) > 9:
                gt = t[9].split(":")[0].replace("|", "/")
                alleles = gt.split("/")
                if len(set(alleles)) < 2:
                    continue
            _add(d, t[0], (int(t[1]) - 1) // window_size)
    return d


def gc_density(fasta: str, window_size: int = 1_000_000):
    """GC fraction (%) per window."""
    d: OrderedDict = OrderedDict()
    for rid, _desc, seq in iter_fasta(fasta):
        arr = np.frombuffer(seq.tobytes().upper(), dtype=np.uint8)
        is_gc = (arr == ord("G")) | (arr == ord("C"))
        is_acgt = is_gc | (arr == ord("A")) | (arr == ord("T"))
        nb = -(-arr.size // window_size)
        for b in range(nb):
            sl = slice(b * window_size, (b + 1) * window_size)
            tot = int(is_acgt[sl].sum())
            if tot:
                _add(d, rid, b, round(100.0 * int(is_gc[sl].sum()) / tot, 2))
    return d


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print(__doc__)
        return 1
    kind, inp, out = argv[:3]
    window = int(argv[3]) if len(argv) > 3 else 1_000_000
    fn = {
        "gene": gene_density,
        "repeat": repeat_density,
        "variant": variant_density,
        "gc": gc_density,
        "bed": bed_density,
    }[kind]
    write_density(fn(inp, window_size=window), out, window)
    return 0


if __name__ == "__main__":
    sys.exit(main())
