"""Stream seconds of the pair-code path's table lookups a job
(``map/search``: ops/mapbins_pair's forward int64 codes, ``torch.searchsorted``
into the significant k-mers and the hit test of each tile, timed by the
pair of CUDA events the program records around each call;
``Pipeline.step_seconds``), the mean over the window's jobs. Nothing where
the program records no such span."""


def read(run):
    return run.step_mean("map/search@device")
