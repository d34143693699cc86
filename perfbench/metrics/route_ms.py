"""API and formats: the program's route_ms span (spgemm_csr's router:
tile_occupancy_estimate, _mxu_reuse, _f32_exact_for, the tiled router;
the ESC route's choose_group_rows). Mean ms per call; None where the
program reports no such span."""


def read(run):
    return run.mean_ms(lambda c: c.get("timings_ms", {}).get("route_ms"))
