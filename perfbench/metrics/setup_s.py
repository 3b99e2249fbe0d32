"""Set-up: the process's start to the end of the warm-up job (CUDA, the
kernel libraries, the genome, one whole job)."""


def read(run):
    return run.setup_s
