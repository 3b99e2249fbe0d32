"""The pair-code path's keys-only int64 sorts' share of their roofline, in
%: the least time of the sorts, each key read once and written once as
int64 (16 bytes a key, the convention of ``sort_int32_pow2_roofline``'s 8
bytes for int32) at the H100's 3.35 TB/s, over their stream seconds.

Keys: the program's counter ``count/sort@int64_keys`` (ops/count_pair's
``_sort64``: every key of every such sort, pads included); seconds: the
CUDA events around the same calls, ``count/sort@device``. Both are means
over the same jobs of the window (``Pipeline.step_seconds``), so their
ratio is the window's keys over its seconds. The denominator is stream
time, not kernel time as in ``sort_int32_pow2_roofline``'s trace: the gaps
between the kernels inside ``torch.sort`` (cub's passes, its allocations)
count against the share. Nothing where the program records neither the
span nor the counter, or no device seconds."""

HBM_BYTES_PER_S = 3.35e12
BYTES_PER_KEY = 16


def read(run):
    keys = run.step_mean("count/sort@int64_keys")
    seconds = run.step_mean("count/sort@device")
    if not keys or not seconds or seconds <= 0:
        return None
    return 100.0 * BYTES_PER_KEY * keys / HBM_BYTES_PER_S / seconds
