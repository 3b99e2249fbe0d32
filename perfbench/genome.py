"""Seeded generator of repeat-rich allopolyploid genomes (FASTA + config).

A frozen copy of the shape of ``tools/gen_wheat_scale.py``, vectorised and
seeded from one number. Each chromosome is a row of 5 kb segments: 62%
copies of families shared by every subgenome, 33% copies of families
specific to the chromosome's subgenome, 5% unique sequence drawn once per
homoeologous set (so homoeologs are colinear), then 0.3% point mutations and
20 runs of 500 N. A third of the families are LTR retrotransposons (TSD, an
800 bp LTR from TG to CA, an internal region with a mutated domain cassette,
the same LTR, TSD).

The config names chromosome ``<sg><set>`` after the FASTA id
``CM<sg><set>.1`` (``new|old``), one homoeologous set a line.

Usage: python -m perfbench.genome OUT SEED SUBGENOMES N_SETS CHROM_BASES
"""

from __future__ import annotations

import os
import sys

import numpy as np

SEG = 5000
LTR_LEN = 800
TSD_LEN = 4
LTR_FRAC = 0.33
SHARED_FAMILIES = 120
SG_FAMILIES = 60
SHARED_SHARE = 0.62
SG_SHARE = 0.33  # up to 0.95; the rest is unique sequence
MUTATION = 0.003
N_RUNS = 20
N_RUN_LEN = 500
LINE = 60

_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
_B = {"A": 0, "C": 1, "G": 2, "T": 3}
_CODON = {
    "A": "GCT", "C": "TGT", "D": "GAT", "E": "GAA", "F": "TTT", "G": "GGT",
    "H": "CAT", "I": "ATT", "K": "AAA", "L": "CTT", "M": "ATG", "N": "AAT",
    "P": "CCT", "Q": "CAA", "R": "CGT", "S": "TCT", "T": "ACT", "V": "GTT",
    "W": "TGG", "Y": "TAT",
}
_AA = "ACDEFGHIKLMNPQRSTVWY"


def _rng(seed: int, *key: int) -> np.random.Generator:
    """One independent stream per (seed, key...); any int seed, negative too."""
    return np.random.default_rng(np.random.SeedSequence([seed & (2**64 - 1), *key]))


def _domain_cassette(rng) -> np.ndarray:
    """RT/INT/RH peptides reverse-translated, as 2-bit bases."""
    peps = {dom: "".join(rng.choice(list(_AA), size=n))
            for dom, n in (("RT", 220), ("INT", 160), ("RH", 130))}
    dna = "".join(_CODON[a] for d in ("INT", "RT", "RH") for a in peps[d])
    return np.array([_B[c] for c in dna], dtype=np.uint8)


def make_library(rng, n_fam: int, cassette: np.ndarray) -> np.ndarray:
    """(n_fam, SEG) uint8 families; the first LTR_FRAC of them are LTR
    retrotransposons."""
    lib = rng.integers(0, 4, (n_fam, SEG), dtype=np.uint8)
    inner_len = SEG - 2 * LTR_LEN - 2 * TSD_LEN
    for fi in range(int(n_fam * LTR_FRAC)):
        tsd = rng.integers(0, 4, TSD_LEN, dtype=np.uint8)
        ltr = rng.integers(0, 4, LTR_LEN, dtype=np.uint8)
        ltr[:2] = (_B["T"], _B["G"])
        ltr[-2:] = (_B["C"], _B["A"])
        inner = rng.integers(0, 4, inner_len, dtype=np.uint8)
        cas = cassette.copy()
        nm = int(cas.size * 0.05)
        p = rng.integers(0, cas.size, nm)
        cas[p] = (cas[p] + rng.integers(1, 4, nm, dtype=np.uint8)) % 4
        inner[10:10 + cas.size] = cas
        lib[fi] = np.concatenate([tsd, ltr, inner, ltr, tsd])
    return lib


def make_set_plan(rng, chrom_bases: int, shared_families: int):
    """The ancestral arrangement of one homoeologous set: each segment's
    kind, its shared family and the unique segments."""
    n_seg = chrom_bases // SEG
    kinds = rng.random(n_seg)
    fam_shared = rng.integers(0, shared_families, n_seg)
    n_uniq = int((kinds >= SHARED_SHARE + SG_SHARE).sum())
    uniq = rng.integers(0, 4, (n_uniq, SEG), dtype=np.uint8)
    return kinds, fam_shared, uniq


def make_chrom(rng, shared_lib, sg_lib, plan) -> np.ndarray:
    """One chromosome as ASCII bytes (ACGT and N)."""
    kinds, fam_shared, uniq = plan
    n_seg = kinds.size
    parts = np.empty((n_seg, SEG), dtype=np.uint8)
    shared = kinds < SHARED_SHARE
    sg = (kinds >= SHARED_SHARE) & (kinds < SHARED_SHARE + SG_SHARE)
    parts[shared] = shared_lib[fam_shared[shared]]
    parts[sg] = sg_lib[rng.integers(0, sg_lib.shape[0], int(sg.sum()))]
    parts[~(shared | sg)] = uniq
    chrom = parts.reshape(-1)
    n_mut = int(chrom.size * MUTATION)
    pos = rng.integers(0, chrom.size, n_mut)
    chrom[pos] = (chrom[pos] + rng.integers(1, 4, n_mut, dtype=np.uint8)) % 4
    seq = _ACGT[chrom]
    for p in rng.integers(0, chrom.size - 600, N_RUNS):
        seq[p:p + N_RUN_LEN] = ord("N")
    return seq


def fasta_record(name: str, seq: np.ndarray) -> bytes:
    """``>name`` and the sequence in lines of LINE bases."""
    rows = seq.size // LINE
    buf = np.empty((rows, LINE + 1), dtype=np.uint8)
    buf[:, :LINE] = seq[:rows * LINE].reshape(rows, LINE)
    buf[:, LINE] = ord("\n")
    tail = seq[rows * LINE:]
    return (f">{name}\n".encode() + buf.tobytes()
            + (tail.tobytes() + b"\n" if tail.size else b""))


def chrom_names(subgenomes: str, n_sets: int):
    """[(config name, FASTA id)] in config order: set by set, subgenome by
    subgenome."""
    return [(f"{sg}{i}", f"CM{sg}{i}.1")
            for i in range(1, n_sets + 1) for sg in subgenomes]


def total_bases(subgenomes: str, n_sets: int, chrom_bases: int) -> int:
    """Bases (N included) of the genome :func:`generate` writes."""
    return len(subgenomes) * n_sets * (chrom_bases // SEG) * SEG


def generate(out_dir: str, seed: int, subgenomes: str, n_sets: int, chrom_bases: int,
             shared_families: int = SHARED_FAMILIES,
             sg_families: int = SG_FAMILIES) -> tuple[str, str]:
    """Writes ``genome.fa`` and ``sg.config`` into ``out_dir``; returns
    their paths. The same arguments give the same bytes."""
    os.makedirs(out_dir, exist_ok=True)
    cassette = _domain_cassette(_rng(seed, 0))
    lib_rng = _rng(seed, 1)
    shared_lib = make_library(lib_rng, shared_families, cassette)
    sg_libs = {sg: make_library(lib_rng, sg_families, cassette) for sg in subgenomes}
    fa = os.path.join(out_dir, "genome.fa")
    cfg = os.path.join(out_dir, "sg.config")
    with open(fa, "wb") as f:
        for i in range(1, n_sets + 1):
            plan = make_set_plan(_rng(seed, 2, i), chrom_bases, shared_families)
            for j, sg in enumerate(subgenomes):
                seq = make_chrom(_rng(seed, 3, i, j), shared_lib, sg_libs[sg], plan)
                f.write(fasta_record(f"CM{sg}{i}.1", seq))
        # on disk before the caller times anything: a write-back left for later
        # would land in the jobs that run next
        f.flush()
        os.fsync(f.fileno())
    names = chrom_names(subgenomes, n_sets)
    with open(cfg, "w") as f:
        for i in range(n_sets):
            row = names[i * len(subgenomes):(i + 1) * len(subgenomes)]
            f.write("\t".join(f"{new}|{old}" for new, old in row) + "\n")
    return fa, cfg


if __name__ == "__main__":
    out, seed, sgs, n_sets, bases = sys.argv[1:6]
    print(generate(out, int(seed), sgs, int(n_sets), int(float(bases))))
