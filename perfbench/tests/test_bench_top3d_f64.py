"""The top3d_f64 configuration at a CPU test's size, and the readers of
its cell's metrics (the new slice_ms and ozaki_kernel_roofline, and the
existing span readers the cell is listed under) on synthetic runs: each
returns nothing where the program reports nothing to read, as a program
without the hi/lo passes' spans does.

Importing this file registers top3d_f64's small size in conftest.SMALL,
so the cell, card, control and fault tests take the new cell whenever
the directory is collected whole."""

import time

import pytest

from conftest import SMALL, small_config
from perfbench import harness, yardstick
from test_bench_nojax import _probe

SMALL["top3d_f64"] = {"nelx": 12, "nely": 4, "nelz": 2}

CELL = "top3d_f64.a2"
OZAKI = {"route_ms": 80.0, "tile_ms": 70.0, "prep_ms": 900.0,
         "slice_ms": 600.0, "symbolic_ms": 10.0, "upload_ms": 250.0,
         "numeric_ms": 120.0, "compact_ms": 3000.0, "download_ms": 400.0,
         "result_ms": 190.0}
# the span readers the cell reports and the timings_ms keys each sums
SPANS = {"slice_ms": ("slice_ms",), "numeric_ms": ("upload_ms",
                                                  "numeric_ms"),
         "assemble_ms": ("compact_ms",), "route_ms": ("route_ms",),
         "tile_ms": ("tile_ms",), "result_ms": ("result_ms",),
         "download_ms": ("download_ms",)}
# a program whose Ozaki route has no slice span
PARENT = {k: v for k, v in OZAKI.items() if k != "slice_ms"}
# the names an H100 trace gives them (torch.profiler, CUPTI)
WGMMA = ("void (anonymous namespace)::ozaki_wgmma_kernel<16, 15>("
         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
         "int const*, int const*, int const*, float*, float*, float*, "
         "float*, (anonymous namespace)::Params)")
COPY = ("void (anonymous namespace)::transpose_kernel<1>(unsigned char "
        "const*, unsigned char*, long, long, long)")


def _run(calls, trace=None, min_bytes=None):
    return harness.Run(cell={}, config={}, traffic={}, setup_s=1.0,
                       window_s=10.0, calls=calls, flops_per_call=2e6,
                       min_bytes_per_call=min_bytes, peak_window_bytes=0,
                       trace=trace)


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def _trace(ops):
    return {"window_s": 10.0, "busy_s": 1.0, "kernel_s": 0.5, "copy_s": 0.5,
            "device_ops": ops, "idle_gaps": []}


def test_cell_registered_with_its_metrics(bench):
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] in SMALL
    cfg = small_config(bench, CELL)
    assert cfg["dtype"] == "float64" and cfg["tiles"] == [64, 128]
    new = {m["name"] for m in bench["per_layer"]
           if m.get("workloads") == [CELL]}
    assert new == {"slice_ms", "ozaki_kernel_roofline"}
    # every layer the cell runs is read there, under the metric that
    # reads it in the f32 cells
    listed = {m["name"] for m in bench["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert listed >= set(SPANS) | {"format_ms", "plan_ms", "unspanned_ms",
                                   "kernels_roofline", "device_idle_pct",
                                   "copy_ms"}


def test_a_run_of_the_cell_loads_no_jax():
    """test_bench_nojax's probe on this cell alone (that test's own loop
    keys its small sizes by the configurations it knew)."""
    bad, program = _probe(f"""
from perfbench import harness
bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
cfg = harness.load_json(harness.ROOT, "perfbench/configs/top3d_f64.json")
cfg.update(nelx=6, nely=3, nelz=2)
harness.run_cell(bench, {CELL!r}, 3, 0.1, False, "cpu", time.perf_counter(),
                 config=cfg)
""")
    assert bad == [] and program


@pytest.mark.parametrize("name", sorted(SPANS))
def test_program_span_readers(name):
    run = _run([{"clock_s": 5.0, "timings_ms": OZAKI},
                {"clock_s": 5.5, "timings_ms": OZAKI},
                {"call": 3, "failed": True}])
    assert _read(name, run) == sum(OZAKI[k] for k in SPANS[name])


def test_slice_ms_is_none_without_its_span():
    run = _run([{"clock_s": 5.0, "timings_ms": PARENT}])
    assert _read("slice_ms", run) is None
    assert _read("assemble_ms", run) == PARENT["compact_ms"]


def test_ozaki_kernel_roofline_reads_the_wgmma_kernel():
    calls = [{"clock_s": 5.0, "timings_ms": OZAKI}] * 4
    ops = [["Memcpy HtoD (Pageable -> Device)", 0.4], [WGMMA, 0.012],
           [COPY, 0.004], ["void transpose_kernel<2>(short)", 0.002],
           ["void at::native::(anonymous namespace)::transpose_kernel<1>",
            9.0]]
    run = _run(calls, _trace(ops), min_bytes=3.35e8)
    least = yardstick.least_seconds(3.35e8, 2e6)
    assert least == pytest.approx(1e-4)
    assert _read("ozaki_kernel_roofline", run) == pytest.approx(
        100.0 * least * 4 / 0.012)


@pytest.mark.parametrize("trace", [None, _trace([["Memcpy DtoH", 0.1]]),
                                   _trace([[COPY, 0.004]])],
                         ids=["untraced", "no_ozaki_kernel", "copy_only"])
def test_ozaki_kernel_roofline_is_none_without_its_kernels(trace):
    run = _run([{"clock_s": 5.0, "timings_ms": OZAKI}], trace,
               min_bytes=3.35e8)
    assert _read("ozaki_kernel_roofline", run) is None


def test_parent_route_is_not_correct_on_the_cell(bench):
    """The one-pass route (explicit backend="ozaki", the auto route before
    the hi/lo split) run in the cell's place misses the limit."""
    import spgemm_tpu_torch as st

    class OnePass:
        def __init__(self, entry):
            self.entry, self.last = entry, {}

        def prepare(self, inp):
            return self.entry.prepare(inp)

        def __call__(self, a):
            c, res = st.spgemm_csr(a, tm=64, tn=128, backend="ozaki",
                                   device=self.entry.device)
            self.last = {"timings_ms": dict(res.timings_ms),
                         "route": res.stats["backend"]}
            return c

        def to_host(self, c):
            return self.entry.to_host(c)

        def close(self):
            self.entry.close()

    res, lines = harness.run_cell(
        bench, CELL, 2**31 + 5, 0.3, False, "cpu", time.perf_counter(),
        config=small_config(bench, CELL), entry_wrap=OnePass)
    assert res["failed"] == 0 and res["correct"] is False, lines
    assert res["checked"]["pattern_mismatches"]["value"] == 0
    assert res["checked"]["max_scaled_err"]["value"] > 1e-9
