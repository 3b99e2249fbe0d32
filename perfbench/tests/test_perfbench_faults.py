"""The check fails runs whose timed path is broken underneath, and its
control: the harness's run on the CPU with one fault planted in the
program, and the plain reference in float32 in the program's place."""

import numpy as np
import pytest

from perfbench import control, harness

SEED = 2**31 + 777


def _fault_unchanged_state(monkeypatch):
    """The mapping step's accumulator is returned as it came in."""
    from subphaser_torch.ops import mapbins

    monkeypatch.setattr(mapbins.BinAccumulator, "add", lambda self, *a, **k: None)


def _fault_half_the_batch(monkeypatch):
    """Every other tile of the genome is left out of counting and mapping."""
    from subphaser_torch.io.genome import PackedGenome

    tiles = PackedGenome.tiles

    def half(self, *a, **k):
        return (t for i, t in enumerate(tiles(self, *a, **k)) if i % 2 == 0)

    monkeypatch.setattr(PackedGenome, "tiles", half)


def _fault_answer_altered(monkeypatch):
    """One bin count is off by one where the file is written."""
    from subphaser_torch.phase import enrich

    write = enrich.write_bin_counts

    def altered(fout, per_chrom, *a, **k):
        per_chrom = [np.array(x) for x in per_chrom]
        per_chrom[0][per_chrom[0].sum(axis=1).argmax(), 0] += 1
        return write(fout, per_chrom, *a, **k)

    monkeypatch.setattr(enrich, "write_bin_counts", altered)


@pytest.mark.parametrize("fault", [_fault_unchanged_state, _fault_half_the_batch,
                                   _fault_answer_altered])
def test_planted_fault_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    res = harness.run_cell(tiny_root, "tiny_abd.core_k15", SEED, 0.5, trace=False,
                           device="cpu")
    assert not res["correct"]
    assert res["failed"] == res["attempted"] >= 1
    assert max(res["numbers"].values()) > 0


@pytest.mark.parametrize("cell", ["tiny_abd.core_k15", "tiny_ab.core_k15"])
def test_control_in_float32_is_not_correct(tiny_root, cell):
    res = control.control_numbers(tiny_root, cell, SEED + 1, "cpu")
    assert not res["correct"]
    assert res["numbers"]["kmer_mat_off"] > 0
