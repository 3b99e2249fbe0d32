"""Subgenome clustering + significant-k-mer identification.

Device k-means/bootstrap (ops/kmeans) wrapped with the reference Cluster's
output semantics (reference Cluster.py:17-194): canonical SG naming, the
chrom-subgenome and sig.kmer-subgenome TSVs, and the significant-k-mer table
(canonical code + reverse complement -> SG) consumed by the mapping step.

Randomness rule: the JAX package draws its k-means++ seeds and bootstrap
resamples from the JAX PRNG, which PyTorch cannot reproduce. Here one
``torch.Generator`` on the run's device, seeded from ``seed``, drives the
k-means fit and then the bootstrap. The port is held to IDENTICAL CANONICAL
LABELS (subgenome assignments, hence identical sig.kmer-subgenome.tsv);
bootstrap support, ARI and V-measure agree where the data phase cleanly
(support near 100) and otherwise differ within sampling noise.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from subphaser_torch.io.encoding import codes_to_kmers, revcomp_code
from subphaser_torch.ops import kmeans as kops
from subphaser_torch.ops import stats_host as hstats
from subphaser_torch.phase.spectrum import KmerMatrix
from subphaser_torch.utils.log import logger


@dataclass
class SigKmers:
    """Significant SG-specific k-mers, in device-ready form."""

    codes: np.ndarray      # int32 (M,) sorted forward codes (canonical + rc)
    sg: np.ndarray         # int32 (M,) SG index per code
    canon_codes: np.ndarray  # int32 canonical codes only (for per-SG stats)
    canon_sg: np.ndarray
    sg_names: list[str] = field(default_factory=list)

    def __len__(self):
        return len(self.codes)


class PhaseCluster:
    def __init__(
        self,
        matrix: KmerMatrix,
        n_clusters: int,
        sg_prefix: str = "SG",
        sg_assigned: dict[str, str] | None = None,
        re_assign: bool = True,
        do_bootstrap: bool = True,
        replicates: int = 1000,
        jackknife: float = 50,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        self.matrix = matrix
        self.chrs = matrix.labels
        self.freqs = matrix.freqs  # (B, C) float64
        self.device = torch.device(device)
        data = torch.from_numpy(self.freqs.T.astype(np.float32)).to(self.device)
        self._data = kops.zscore(data, axis=0)  # rows: chrom, cols: kmer
        self.data = self._data.cpu().numpy()
        self.n_clusters = n_clusters
        self.sg_prefix = sg_prefix
        self.order = np.argsort(self.chrs)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)

        if sg_assigned:
            logger.info("Skip k-means clustering (using -sg_assigned)")
            raw = [sg_assigned[c] for c in self.chrs]
            self.n_clusters = len(set(sg_assigned.values()))
            if re_assign:
                labels = self._strings_to_labels(raw)
                labels = kops.canonical_labels(
                    torch.from_numpy(labels), self.order, self.n_clusters
                ).numpy()
            else:
                # keep user naming untouched
                self.d_sg = OrderedDict(zip(self.chrs, raw))
                self.labels = np.array(self._strings_to_labels(raw))
                self.sg_names = sorted(set(raw))
                self._finish_bootstrap(do_bootstrap, replicates, jackknife, gen)
                return
        else:
            raw_labels, _inertia = kops.kmeans_fit(self._data, gen, self.n_clusters)
            labels = kops.canonical_labels(
                raw_labels, self.order, self.n_clusters
            ).cpu().numpy()
        self.labels = labels
        width = len(str(self.n_clusters))
        self.d_sg = OrderedDict(
            (c, f"{sg_prefix}{int(l) + 1:0>{width}d}") for c, l in zip(self.chrs, labels)
        )
        self.sg_names = sorted(set(self.d_sg.values()))
        self._finish_bootstrap(do_bootstrap, replicates, jackknife, gen)

    def _strings_to_labels(self, raw: list[str]) -> np.ndarray:
        name_order = {s: i for i, s in enumerate(sorted(set(raw)))}
        return np.array([name_order[s] for s in raw])

    def _finish_bootstrap(self, do_bootstrap, replicates, jackknife, gen):
        self.d_bs: dict[str, int] = {}
        self.mean_ari = self.mean_vm = None
        if not do_bootstrap:
            return
        logger.info(
            "Performing bootstrap of %d replicates (resampling %d kmers "
            "with replacement per replicate)", replicates, replicates,
        )
        support, ari, vm = kops.bootstrap(
            self._data,
            self.labels,
            self.order,
            gen,
            n_clusters=self.n_clusters,
            replicates=replicates,
        )
        self.d_bs = dict(zip(self.chrs, support.cpu().tolist()))
        self.mean_ari = float(ari)
        self.mean_vm = float(vm)
        logger.info(
            "Bootstrap: mean Adjusted Rand-Index: %.4f; mean V-measure score: %.4f",
            self.mean_ari, self.mean_vm,
        )

    # ---- outputs ------------------------------------------------------
    def output_subgenomes(self, fout) -> None:
        """chrom-subgenome TSV (reference Cluster.py:144-150)."""
        fout.write("#chrom\tsubgenome\tbootstrap\n")
        for chrom, sg in sorted(self.d_sg.items(), key=lambda x: x[1]):
            fout.write(f"{chrom}\t{sg}\t{self.d_bs.get(chrom, '')}\n")

    def group_idx_by_sg(self) -> list[np.ndarray]:
        """Chromosome indices per SG, in sorted SG-name order."""
        groups: dict[str, list[int]] = {}
        for i, (chrom, sg) in enumerate(self.d_sg.items()):
            groups.setdefault(sg, []).append(i)
        return [np.array(groups[sg]) for sg in sorted(groups)]

    def output_kmers(
        self,
        fout,
        k: int,
        max_pval: float = 0.05,
        test_method: str = "ttest_ind",
    ) -> SigKmers:
        """sig.kmer-subgenome TSV + significant-code table.

        Per differential k-mer: test values of the top-mean SG against the
        second (reference Cluster.py:151-194); keep unless p > max_pval
        (NaN p-values are kept, matching the reference's comparison).
        """
        group_idx = self.group_idx_by_sg()
        if len(group_idx) < 2:
            raise ValueError("Need at least 2 subgenomes to identify specific kmers")
        top, pvals, means = hstats.test_top2(self.freqs, group_idx, method=test_method)
        with np.errstate(invalid="ignore"):
            keep = ~(pvals > max_pval)  # NaN kept, reference parity
        codes = self.matrix.codes
        kmers = codes_to_kmers(codes, k)
        fout.write("#kmer\tsubgenome\tp_value\tratios\n")
        sgs = sorted(set(self.d_sg.values()))
        for i in np.flatnonzero(keep):
            ratios = ",".join(repr(float(v)) for v in means[i])
            fout.write(f"{kmers[i]}\t{sgs[top[i]]}\t{float(pvals[i])!r}\t{ratios}\n")

        # k <= 15 codes fit int32 (device table dtype); larger k stay int64
        dtype = np.int32 if k <= 15 else np.int64
        canon = codes[keep].astype(dtype)
        canon_sg = top[keep].astype(np.int32)
        rc = revcomp_code(canon.astype(np.int64), k).astype(dtype)
        both = np.concatenate([canon, rc])
        both_sg = np.concatenate([canon_sg, canon_sg])
        order = np.argsort(both, kind="stable")
        sig = SigKmers(
            codes=both[order],
            sg=both_sg[order],
            canon_codes=canon,
            canon_sg=canon_sg,
            sg_names=sgs,
        )
        logger.info("%d significant subgenome-specific kmers", len(canon))
        for si, sg in enumerate(sgs):
            logger.info("\t%d %s-specific kmers", int((canon_sg == si).sum()), sg)
        return sig

    def pca(self, n_components: int = 2):
        """PCA scores for plotting (reference Cluster.py:48-54), computed on
        the cluster's device, z-scored, returned as numpy."""
        from subphaser_torch.ops.pca import pca_fit_transform

        n_components = min(n_components, len(self.chrs))
        scores, ratio = pca_fit_transform(self._data, n_components)
        scores = kops.zscore(scores, axis=0)
        return scores.cpu().numpy(), ratio.cpu().numpy()


def write_matrix_file(matrix: KmerMatrix, k: int, fout) -> None:
    """kmer.mat TSV (reference Jellyfish.py:515-520): normalized frequencies."""
    fout.write("kmer\t" + "\t".join(matrix.labels) + "\n")
    kmers = codes_to_kmers(matrix.codes, k)
    freqs = matrix.freqs
    for i in range(len(kmers)):
        row = "\t".join(repr(float(v)) for v in freqs[i])
        fout.write(f"{kmers[i]}\t{row}\n")


def load_matrix_file(path: str, k: int) -> KmerMatrix:
    """Read a kmer.mat back (normalized freqs; counts unavailable)."""
    from subphaser_torch.io.encoding import kmer_code
    from subphaser_torch.io.fasta import xopen

    with xopen(path, "rt") as f:
        header = f.readline().rstrip("\n").split("\t")
        labels = header[1:]
        codes, rows = [], []
        for line in f:
            parts = line.rstrip("\n").split("\t")
            codes.append(kmer_code(parts[0]))
            rows.append([float(v) for v in parts[1:]])
    freqs = np.array(rows, dtype=np.float64)
    return KmerMatrix(
        codes=np.array(codes, dtype=np.int32),
        counts=np.zeros(freqs.shape, dtype=np.int32),
        tot=np.zeros(len(codes), dtype=np.int64),
        lengths=np.ones(len(labels), dtype=np.int64),
        labels=labels,
        freqs_override=freqs,
    )
