"""Carry state in from numpy arrays.

The phaser has no weights: its state is the packed genome, the
per-chromosome spectra and the step checkpoints. The checkpoints keep the
JAX package's file format (utils/checkpoint), so the port resumes from a
tmpdir that either package wrote. These builders take the same state as
plain numpy arrays, as the JAX package's ``PackedGenome`` and
``ChromSpectrum`` hold it, so both packages can be fed identical input.
"""

from __future__ import annotations

import numpy as np

from subphaser_torch.io.genome import PackedChromosome, PackedGenome
from subphaser_torch.phase.spectrum import ChromSpectrum


def genome_from_numpy(chroms) -> PackedGenome:
    """Iterable of (name, length, packed int32, vmask int32) -> PackedGenome."""
    g = PackedGenome()
    for name, length, packed, vmask in chroms:
        g.chroms.append(PackedChromosome(
            name=str(name), length=int(length),
            packed=np.ascontiguousarray(packed, dtype=np.int32),
            vmask=np.ascontiguousarray(vmask, dtype=np.int32),
        ))
    return g


def spectra_from_numpy(spectra) -> list[ChromSpectrum]:
    """Iterable of (name, codes, counts int64, total) -> spectra. Codes are
    int32 for k <= 15 and stay int64 when given as int64 (pair codes, k > 15)."""
    return [
        ChromSpectrum(name=str(name),
                      codes=np.ascontiguousarray(
                          codes, dtype=np.int64 if np.asarray(codes).dtype == np.int64
                          else np.int32),
                      counts=np.ascontiguousarray(counts, dtype=np.int64),
                      total=int(total))
        for name, codes, counts, total in spectra
    ]
