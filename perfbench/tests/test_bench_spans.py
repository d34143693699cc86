"""The readers of the program's spans (route_ms, tile_ms, result_ms,
download_ms, unspanned_ms) on synthetic runs: None where the program
reports no such span (as a program without spans does), and format_ms
split into the spans it held and the remainder no span names."""

import pytest

from perfbench import harness

NEW = ("route_ms", "tile_ms", "result_ms", "download_ms", "unspanned_ms")


def _run(calls):
    return harness.Run(cell={}, config={}, traffic={}, setup_s=1.0,
                       window_s=10.0, calls=calls, flops_per_call=1.0,
                       min_bytes_per_call=None, peak_window_bytes=0)


STRIP = {"route_ms": 310.5, "tile_ms": 41.25, "prep_ms": 130.0,
         "symbolic_ms": 12.5, "upload_ms": 150.0, "numeric_ms": 330.0,
         "download_ms": 74.0, "compact_ms": 2900.0, "result_ms": 5.75}
ESC = {"route_ms": 30.0, "symbolic_ms": 1900.0, "upload_ms": 150.0,
       "numeric_ms": 100.0, "compact_ms": 140.0, "download_ms": 60.0,
       "result_ms": 3.0}
# the phases a program without spans reports
PHASES = {"prep_ms", "symbolic_ms", "upload_ms", "numeric_ms", "compact_ms"}


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


@pytest.mark.parametrize("name", NEW)
def test_reader_is_none_without_its_span(name):
    seed = {k: v for k, v in STRIP.items() if k in PHASES}
    run = _run([{"clock_s": 4.0, "timings_ms": seed},
                {"clock_s": 4.5, "timings_ms": seed},
                {"call": 3, "failed": True}])
    assert _read(name, run) is None


def test_tile_ms_reads_only_the_calls_that_tiled():
    run = _run([{"clock_s": 4.0, "timings_ms": STRIP},
                {"clock_s": 2.5, "timings_ms": ESC}])
    assert _read("tile_ms", run) == STRIP["tile_ms"]
    assert _read("route_ms", run) == (STRIP["route_ms"]
                                      + ESC["route_ms"]) / 2


@pytest.mark.parametrize("calls", [
    [(4.0, STRIP), (4.25, STRIP)],
    [(2.5, ESC), (3.0, ESC)],
], ids=["strip", "esc"])
def test_format_ms_is_the_spans_plus_the_remainder(calls):
    run = _run([{"clock_s": s, "timings_ms": t} for s, t in calls])
    parts = [_read(n, run) for n in ("route_ms", "tile_ms", "result_ms",
                                     "unspanned_ms")]
    total = sum(p or 0.0 for p in parts)
    assert _read("format_ms", run) == pytest.approx(total, abs=1e-9)
    # the child is not a top-level span: it moves nothing here
    unspanned = _read("unspanned_ms", run)
    clock = sum(s for s, _ in calls) / len(calls) * 1e3
    top = sum(v for k, v in calls[0][1].items() if k != "download_ms")
    assert unspanned == pytest.approx(clock - top, abs=1e-9)
