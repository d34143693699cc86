"""assembly: the program's compact_ms (the strip route's TileMat
assembly; the ESC route's host trim). Mean ms per call."""


def read(run):
    return run.phase_ms("compact_ms")
