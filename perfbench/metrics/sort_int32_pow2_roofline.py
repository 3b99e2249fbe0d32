"""``sort_int32_pow2``'s share of its roofline, in %: the least time of
its sorts, each key read once and written once as int32 (8 bytes a key) at
the H100's 3.35 TB/s, over the device time of the kernels launched inside
the calls (profiler trace of one job). Nothing where the trace lost a sort
the program counted."""

HBM_BYTES_PER_S = 3.35e12
BYTES_PER_KEY = 8


def read(run):
    t = run.trace
    if not run.trace_whole or not t.sort_keys or t.sort_device_s <= 0:
        return None
    return 100.0 * BYTES_PER_KEY * t.sort_keys / HBM_BYTES_PER_S / t.sort_device_s
