"""Counting orchestration: genome -> per-chromosome spectra -> k-mer matrix.

Device work is the per-tile canonical-code extraction + sort/RLE
(ops/count); this module streams tiles to the device, accumulates spectra,
applies the ``lower_count`` dump threshold (jellyfish ``dump -L``, reference
Jellyfish.py:697-703), and assembles the sparse candidate count matrix the
differential filter consumes (reference Jellyfish.py:439-460).

Single-process paths for every supported k: int32 codes for k <= 15, (hi, lo)
pair codes (ops/count_pair) for 16 <= k <= 31. Multi-device / multi-process
counting (ROADMAP A12) raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from subphaser_torch.io.genome import DEFAULT_TILE_BASES, PackedGenome
from subphaser_torch.ops.count import (
    SpectrumAccumulator,
    count_codes_async,
    count_codes_collect,
    count_tile,
    count_tile_batch,
    extract_codes_batch,
    merge_host,
)
from subphaser_torch.ops.count_pair import (
    PairSpectrumAccumulator,
    count_pair_codes_threshold,
    count_tile_batch_pair,
    extract_pair_codes_batch,
)
from subphaser_torch.utils.log import logger
from subphaser_torch.utils.profiling import Throughput


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
) -> list[ChromSpectrum]:
    """Count canonical k-mers per chromosome on ``device``.

    Checkpoints key on each chromosome's full-content signature, so a
    changed target set reuses every unchanged chromosome's spectrum (the
    reference's -re_filter workflow, __main__.py:352-354) while any sequence
    edit invalidates it. The checkpoint files are the JAX package's format.
    """
    if torch.distributed.is_available() and torch.distributed.is_initialized() \
            and torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "multi-process counting is not ported yet (ROADMAP A12)")
    device = torch.device(device)
    n_pos_words = tile_bases // 16
    spectra: list[ChromSpectrum] = []
    meter = Throughput("kmer counting", unit="Mbp")
    counted_mbp = 0.0

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    def batches_of(tiles):
        for lo in range(0, len(tiles), batch_tiles):
            batch = tiles[lo : lo + batch_tiles]
            if len(batch) == 1:
                yield to_dev(batch[0].words), to_dev(batch[0].vwords)
                continue
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
            yield to_dev(words), to_dev(vwords)

    for ci, chrom in enumerate(genome.chroms):
        params = {
            "k": k,
            "lower_count": lower_count,
            "chrom_sig": chrom.signature(),
        }
        ckp_name = f"spectrum.{chrom.name}"
        if checkpoint is not None and checkpoint.has(ckp_name, params):
            payload = checkpoint.load(ckp_name)
            spectra.append(ChromSpectrum(
                name=chrom.name,
                codes=payload["codes"],
                counts=payload["counts"],
                total=int(payload["total"]),
            ))
            logger.info("Loaded spectrum checkpoint for %s", chrom.name)
            continue
        if counted_mbp == 0.0:
            meter.start()
        counted_mbp += chrom.length / 1e6

        def chrom_tiles(ci_local=ci):
            return [t for t in genome.tiles(k, tile_bases=tile_bases)
                    if t.chrom_index == ci_local]

        tiles = chrom_tiles()
        n_positions = len(tiles) * 16 * n_pos_words
        if k > 15 and n_positions <= device_budget // 2:
            # pair codes are two int32 words, so the fast path (one sort
            # over the chromosome's raw codes) fits half the budget
            parts = [extract_pair_codes_batch(w, v, k, n_pos_words)
                     for w, v in batches_of(tiles)]
            codes, counts = count_pair_codes_threshold(parts, lower_count)
            del parts
        elif k > 15:
            pacc = PairSpectrumAccumulator(device_budget=device_budget)
            for words, vwords in batches_of(tiles):
                pacc.add(*count_tile_batch_pair(words, vwords, k, n_pos_words))
            codes, counts = pacc.finish(lower_count)
        elif n_positions <= device_budget:
            # fast path: hold the chromosome's raw codes on device and run
            # ONE keys-only sort
            def rebuild(tiles_=None):
                return [extract_codes_batch(w, v, k, n_pos_words)
                        for w, v in batches_of(tiles_ or chrom_tiles())]

            handles = count_codes_async(rebuild(tiles), lower_count, static_cap=1 << 23)
            codes, counts = count_codes_collect(handles, lower_count, rebuild)
        else:
            # accumulator path (chromosome exceeds the device budget):
            # per-batch count + device merges
            acc = SpectrumAccumulator(device_budget=device_budget)
            for words, vwords in batches_of(tiles):
                if words.dim() == 1:
                    u, c = count_tile(words, vwords, k, n_pos_words)
                else:
                    u, c = count_tile_batch(words, vwords, k, n_pos_words)
                acc.add(u, c)
            handles = acc.finish_async(lower_count)
            if handles is not None:
                codes, counts = count_codes_collect(handles, lower_count)
            else:  # host spills force the synchronous merge
                codes, counts = acc.finish(lower_count)
        total = int(counts.sum())
        logger.info(
            "Counted %s: %d distinct k-mers (count >= %d), %d total",
            chrom.name, codes.size, lower_count, total,
        )
        if checkpoint is not None:
            checkpoint.save(ckp_name, params, codes=codes, counts=counts, total=total)
        spectra.append(ChromSpectrum(name=chrom.name, codes=codes, counts=counts, total=total))

    if counted_mbp > 0:
        meter.stop(counted_mbp)
        meter.log()
    return spectra


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
