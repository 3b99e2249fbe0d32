"""Share of one job's traced window, in %, in which no kernel, copy or
memset ran on the card (1 - the union of their intervals over the
window). Nothing where the trace lost a sort the program counted."""


def read(run):
    t = run.trace
    if not run.trace_whole or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
