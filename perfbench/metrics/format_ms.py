"""API and formats: the harness's clock around the call minus the sum of
the program's own phases (SpGEMMResult.timings_ms): what is left is the
tiling, the router's estimate and the conversion of C to CSR. Mean ms
per call."""

PHASES = ("prep_ms", "symbolic_ms", "upload_ms", "numeric_ms", "compact_ms")


def read(run):
    return run.mean_ms(
        lambda c: c["clock_s"] * 1e3 - sum(c["timings_ms"].get(k, 0.0)
                                           for k in PHASES)
        if "timings_ms" in c else None)
