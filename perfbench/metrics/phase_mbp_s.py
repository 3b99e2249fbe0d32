"""Genome phased per second: the bases of every job of the window over
the window's whole length (its opening to the end of its last job)."""


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return sum(j.bases for j in run.done) / 1e6 / run.window_s
