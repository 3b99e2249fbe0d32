"""Whole sorts through ``sort_smem.sort_int32_pow2`` a job
(``sort_smem.launches`` over the window, over its jobs)."""


def read(run):
    return run.sort_launches / len(run.jobs) if run.jobs else None
