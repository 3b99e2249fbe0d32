"""The frozen genome generator: the same seed gives the same bytes, another
seed other bases of the same shape."""

import hashlib
import os

from perfbench import genome, reference


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_same_seed_same_bytes(tmp_path):
    a = genome.generate(str(tmp_path / "a"), 2**31 + 12345, "ABD", 2, 60_000, 6, 3)
    b = genome.generate(str(tmp_path / "b"), 2**31 + 12345, "ABD", 2, 60_000, 6, 3)
    assert _digest(a[0]) == _digest(b[0]) and _digest(a[1]) == _digest(b[1])


def test_other_seed_same_shape(tmp_path):
    a = genome.generate(str(tmp_path / "a"), 7, "AB", 2, 60_000, 6, 3)
    b = genome.generate(str(tmp_path / "b"), -7, "AB", 2, 60_000, 6, 3)
    assert _digest(a[0]) != _digest(b[0])
    sa, sb = reference.read_fasta(a[0]), reference.read_fasta(b[0])
    assert list(sa) == list(sb) == ["CMA1.1", "CMB1.1", "CMA2.1", "CMB2.1"]
    assert [s.size for s in sa.values()] == [s.size for s in sb.values()] == [60_000] * 4
    assert sum(s.size for s in sa.values()) == genome.total_bases("AB", 2, 60_000)
    for seq in sa.values():
        assert set(seq.tobytes()) <= set(b"ACGTN")
        assert (seq == ord("N")).sum() <= genome.N_RUNS * genome.N_RUN_LEN


def test_config_names_sets_and_renames(tmp_path):
    _fa, cfg = genome.generate(str(tmp_path), 1, "ABD", 2, 30_000, 6, 3)
    with open(cfg) as f:
        assert f.read() == ("A1|CMA1.1\tB1|CMB1.1\tD1|CMD1.1\n"
                            "A2|CMA2.1\tB2|CMB2.1\tD2|CMD2.1\n")
    assert reference.read_config(cfg)[1] == [("A2", "CMA2.1"), ("B2", "CMB2.1"),
                                              ("D2", "CMD2.1")]


def test_homoeologs_share_the_set_plan(tmp_path):
    """Unique segments are drawn once per set: A1 and B1 share them."""
    fa, _ = genome.generate(str(tmp_path), 99, "AB", 1, 200_000, 6, 3)
    s = reference.read_fasta(fa)
    a = s["CMA1.1"].reshape(-1, genome.SEG)
    b = s["CMB1.1"].reshape(-1, genome.SEG)
    same = (a == b).mean(axis=1)
    assert (same > 0.85).sum() >= 0.55 * len(same)  # shared and unique segments, N runs aside
    assert os.path.getsize(fa) > 200_000
