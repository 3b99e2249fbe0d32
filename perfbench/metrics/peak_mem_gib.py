"""The card's peak allocated memory over the window's jobs, in GiB
(``torch.cuda.max_memory_allocated``, reset when the window opens)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
