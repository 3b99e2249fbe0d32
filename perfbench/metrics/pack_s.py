"""Seconds of the program's ``pack`` step a job (``Pipeline.step_seconds``),
the mean over the window's jobs."""


def read(run):
    return run.step_mean("pack")
