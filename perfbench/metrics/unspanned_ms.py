"""API and formats: the harness's clock around the call minus every
top-level span of the program (SpGEMMResult.timings_ms): the time inside
the call that no span names, such as freeing the result's plan when the
entry drops it. Mean ms per call; None where the program reports no
route_ms span (a program without spans has no remainder to tell).

format_ms = route_ms + tile_ms + result_ms + unspanned_ms per call."""

TOP = ("route_ms", "tile_ms", "prep_ms", "symbolic_ms", "upload_ms",
       "numeric_ms", "compact_ms", "result_ms")


def read(run):
    def left(c):
        t = c.get("timings_ms", {})
        if "route_ms" not in t:
            return None
        return c["clock_s"] * 1e3 - sum(t.get(k, 0.0) for k in TOP)
    return run.mean_ms(left)
