"""API and formats: the program's result_ms span (C to CSR and the
nnzCub count on tiled routes; the nnzCub count and the stats on the ESC
route). Mean ms per call; None where the program reports no such
span."""


def read(run):
    return run.mean_ms(lambda c: c.get("timings_ms", {}).get("result_ms"))
