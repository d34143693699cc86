"""API and formats: the program's tile_ms span (csr_to_tiles of A and
the tiled B role; tiled routes only). Mean ms per call; None where the
program reports no such span."""


def read(run):
    return run.mean_ms(lambda c: c.get("timings_ms", {}).get("tile_ms"))
