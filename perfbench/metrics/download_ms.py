"""numeric: the program's download_ms span, the device-to-host copies
of C's planes and their host conversion (a child of numeric_ms on the
strip route, of compact_ms on the ESC route). Mean ms per call; None
where the program reports no such span."""


def read(run):
    return run.mean_ms(lambda c: c.get("timings_ms", {}).get("download_ms"))
