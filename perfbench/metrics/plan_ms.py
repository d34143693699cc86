"""plan: the program's prep_ms + symbolic_ms (strip prep and symbolic;
the ESC route's host plan). Mean ms per call."""


def read(run):
    return run.phase_ms("prep_ms", "symbolic_ms")
