"""Counting orchestration: genome -> per-chromosome spectra -> k-mer matrix.

Device work is the per-tile canonical-code extraction + sort/RLE
(ops/count); this module streams tiles to the device, accumulates spectra,
applies the ``lower_count`` dump threshold (jellyfish ``dump -L``, reference
Jellyfish.py:697-703), and assembles the sparse candidate count matrix the
differential filter consumes (reference Jellyfish.py:439-460).

One counting path for every supported k (ops/count): int32 codes for
k <= 15, int64 pair codes for 16 <= k <= 31. Several processes
(parallel/distributed) count the chromosomes each owns and exchange the
spectra; a mesh of devices (parallel/sharded_count) counts each chromosome
over its "data" axis, k <= 15.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from subphaser_torch.io.genome import DEFAULT_TILE_BASES, PackedGenome
from subphaser_torch.ops.count import (
    SpectrumAccumulator,
    code_dtype,
    count_codes_threshold,
    count_tile_batch,
    extract_codes_batch,
    fits_one_sort,
    merge_host,
)
from subphaser_torch.ops.count_pair import PairSpectrumAccumulator
from subphaser_torch.parallel.distributed import (
    exchange_chrom_spectra,
    owns_chrom,
    rank_world,
)
from subphaser_torch.parallel.sharded_count import sharded_spectrum
from subphaser_torch.utils.log import logger
from subphaser_torch.utils.profiling import span


@dataclass
class ChromSpectrum:
    name: str
    codes: np.ndarray   # sorted unique canonical codes (count>=lower): int32, int64 for k > 15
    counts: np.ndarray  # int64
    total: int          # sum of counts (== reference dump "tot" / lengths[i])


def count_genome(
    genome: PackedGenome,
    k: int,
    lower_count: int = 3,
    tile_bases: int = DEFAULT_TILE_BASES,
    device_budget: int = 1 << 28,
    batch_tiles: int = 4,
    checkpoint=None,
    device: torch.device | str = "cuda",
    mesh=None,
) -> list[ChromSpectrum]:
    """Count canonical k-mers per chromosome on ``device``.

    Checkpoints key on each chromosome's full-content signature, so a
    changed target set reuses every unchanged chromosome's spectrum (the
    reference's -re_filter workflow, __main__.py:352-354) while any sequence
    edit invalidates it. The checkpoint files are the JAX package's format.

    Several processes (a ``torch.distributed`` group): each rank counts the
    chromosomes it owns (round-robin) and one exchange of the thresholded
    spectra completes every rank's set (the reference's DRMAA array jobs
    and parent merge, RunCmdsMP.py:38-217). With ``mesh`` (parallel/mesh,
    a "data" axis of more than one shard) and k <= 15, each chromosome's
    tiles are counted over the mesh with the code-range exchange
    (parallel/sharded_count). Either way the spectra equal one device's, so
    the files downstream are the same bytes.
    """
    device = torch.device(device)
    n_pos_words = tile_bases // 16
    results: dict[int, ChromSpectrum] = {}
    rank, nproc = rank_world()
    if nproc > 1:
        logger.info(
            "Distributed counting: process %d/%d owns %d of %d chromosomes",
            rank, nproc, sum(owns_chrom(i) for i in range(len(genome.chroms))),
            len(genome.chroms),
        )

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    def stage(batch):
        if len(batch) == 1:
            return to_dev(batch[0].words), to_dev(batch[0].vwords)
        words = np.stack([t.words for t in batch])
        vwords = np.stack([t.vwords for t in batch])
        if len(batch) < batch_tiles:
            # pad with empty (all-invalid) tiles to keep one batch shape
            pad = batch_tiles - len(batch)
            words = np.concatenate(
                [words, np.zeros((pad,) + words.shape[1:], words.dtype)]
            )
            vwords = np.concatenate(
                [vwords, np.zeros((pad,) + vwords.shape[1:], vwords.dtype)]
            )
        return to_dev(words), to_dev(vwords)

    def batches_of(tiles):
        for lo in range(0, len(tiles), batch_tiles):
            with span("stage"):
                staged = stage(tiles[lo : lo + batch_tiles])
            yield staged

    for ci, chrom in enumerate(genome.chroms):
        if nproc > 1 and not owns_chrom(ci):
            continue
        with span("key"):  # hashes the chromosome's packed words and masks
            params = {
                "k": k,
                "lower_count": lower_count,
                "chrom_sig": chrom.signature(),
            }
        ckp_name = f"spectrum.{chrom.name}"
        if checkpoint is not None and checkpoint.has(ckp_name, params):
            payload = checkpoint.load(ckp_name)
            results[ci] = ChromSpectrum(
                name=chrom.name,
                codes=payload["codes"],
                counts=payload["counts"],
                total=int(payload["total"]),
            )
            logger.info("Loaded spectrum checkpoint for %s", chrom.name)
            continue

        with span("tiles"):
            tiles = [t for t in genome.tiles(k, tile_bases=tile_bases) if t.chrom_index == ci]
        n_positions = len(tiles) * 16 * n_pos_words
        if mesh is not None and k <= 15 and mesh.shape.get("data", 1) > 1:
            codes, counts = sharded_spectrum(mesh, tiles, k, n_pos_words)
            keep = counts >= lower_count
            codes, counts = codes[keep], counts[keep]
            logger.info("Counted %s on %d devices", chrom.name, mesh.shape["data"])
        elif fits_one_sort(n_positions, k, device_budget):
            # fast path: hold the chromosome's raw codes on device and run
            # ONE keys-only sort
            parts = [extract_codes_batch(w, v, k, n_pos_words) for w, v in batches_of(tiles)]
            codes, counts = count_codes_threshold(parts, lower_count, code_dtype(k))
            del parts
        else:
            # accumulator path (chromosome exceeds the device budget):
            # per-batch count + device merges; at k > 15 the subclass whose
            # merges perfbench's pair-path test counts through ops/count_pair
            acc = (PairSpectrumAccumulator if k > 15 else SpectrumAccumulator)(device_budget)
            for words, vwords in batches_of(tiles):
                acc.add(*count_tile_batch(words, vwords, k, n_pos_words))
            codes, counts = acc.finish(lower_count)
        total = int(counts.sum())
        logger.info(
            "Counted %s: %d distinct k-mers (count >= %d), %d total",
            chrom.name, codes.size, lower_count, total,
        )
        if checkpoint is not None:
            with span("save"):
                checkpoint.save(ckp_name, params, codes=codes, counts=counts, total=total)
        results[ci] = ChromSpectrum(name=chrom.name, codes=codes, counts=counts, total=total)

    if nproc > 1:
        exchange_chrom_spectra(results, [c.name for c in genome.chroms],
                               codes_dtype=np.int64 if k > 15 else np.int32)
    return [results[ci] for ci in range(len(genome.chroms))]


@dataclass
class KmerMatrix:
    codes: np.ndarray    # (B,) sorted candidate canonical codes (int64 for k > 15)
    counts: np.ndarray   # int32 (B, C)
    tot: np.ndarray      # int64 (B,) genome-wide totals
    lengths: np.ndarray  # int64 (C,) per-chromosome totals
    labels: list[str]
    freqs_override: np.ndarray | None = None  # set when loaded from a .mat file

    @property
    def freqs(self) -> np.ndarray:
        """Normalized frequencies count/chrom_total, float64 (matrix file values)."""
        if self.freqs_override is not None:
            return self.freqs_override
        return self.counts.astype(np.float64) / self.lengths.astype(np.float64)[None, :]


def build_matrix(
    spectra: list[ChromSpectrum],
    min_total: int | float = 1,
    max_total: int | float = float("inf"),
) -> KmerMatrix:
    """Assemble the chrom x k-mer count matrix for candidate k-mers.

    ``min_total``/``max_total`` pre-apply the reference's total-count window
    (Jellyfish.py:617) so the dense matrix only holds candidates.
    """
    lengths = np.array([s.total for s in spectra], dtype=np.int64)
    zero = [s.name for s in spectra if s.total == 0]
    if zero:
        raise ValueError(f"Chromosomes {zero} have only 0 kmers")
    all_codes, tot = merge_host([(s.codes, s.counts) for s in spectra])
    window = (tot >= min_total) & (tot <= max_total)
    cand = all_codes[window]
    cand_tot = tot[window]
    mat = np.zeros((cand.size, len(spectra)), dtype=np.int32)
    for j, s in enumerate(spectra):
        idx = np.searchsorted(cand, s.codes)
        idx_c = np.minimum(idx, max(cand.size - 1, 0))
        m = (idx < cand.size) & (cand.size > 0)
        if cand.size:
            m &= cand[idx_c] == s.codes
        mat[idx_c[m], j] = s.counts[m]
    logger.info(
        "Matrix: %d candidate k-mers (of %d distinct) x %d chromosomes",
        cand.size, all_codes.size, len(spectra),
    )
    return KmerMatrix(
        codes=cand,
        counts=mat,
        tot=cand_tot,
        lengths=lengths,
        labels=[s.name for s in spectra],
    )
