"""Set-up: process start to the first timed call (imports, the card's
context, the matrix, the entry's own set-up, the warm-up call and, in a
checkout's first run, the kernels' build)."""


def read(run):
    return run.setup_s
