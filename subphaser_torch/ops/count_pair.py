"""Two names of pair-code (k > 15) counting that the benchmark's own test,
perfbench/tests/test_perfbench_pair_path.py, replaces to count a k 17 job's
merges and host spills. Counting is ops/count's at every k; the k > 15
accumulator is this subclass only so that its merges go through a
module-level function the test can patch."""

from __future__ import annotations

from subphaser_torch.ops.count import SpectrumAccumulator, merge_rle_many


def merge_rle_many_pair(parts, lower_count: int = 1):
    """:func:`ops.count.merge_rle_many` on int64 parts."""
    return merge_rle_many(parts, lower_count)


class PairSpectrumAccumulator(SpectrumAccumulator):
    """:class:`ops.count.SpectrumAccumulator` that merges by
    :func:`merge_rle_many_pair`."""

    def _merge(self, parts, lower_count: int = 1):
        return merge_rle_many_pair(parts, lower_count)
