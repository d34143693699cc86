"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole), and the plain reference loads nothing of the program."""

import subprocess
import sys

from conftest import ROOT

PROBE = r"""
import sys, time
sys.path.insert(0, {root!r})
{body}
bad = sorted({{m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "flax", "spgemm_tpu")}})
print("BAD", bad)
print("PROGRAM", sorted(m for m in sys.modules
                        if m.split(".")[0] == "spgemm_tpu_torch"))
"""

RUN_CELL = """
from perfbench import harness, run
bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
for name in [w["name"] for w in bench["workloads"]]:
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cfg = harness.load_json(harness.ROOT, next(
        c for c in bench["configs"] if c["name"] == cell["config"])["file"])
    cfg.update({"top3d": dict(nelx=6, nely=3, nelz=2),
                "graph500_s14": dict(scale=7)}[cell["config"]])
    harness.run_cell(bench, name, 3, 0.1, False, "cpu", time.perf_counter(),
                     config=cfg)
"""


def _probe(body):
    out = subprocess.run([sys.executable, "-c",
                          PROBE.format(root=ROOT, body=body)],
                         capture_output=True, text=True, timeout=600,
                         cwd="/")
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines()
                 if line.startswith(("BAD", "PROGRAM")))
    return eval(lines["BAD"]), eval(lines["PROGRAM"])


def test_a_run_loads_no_jax():
    bad, program = _probe(RUN_CELL)
    assert bad == []
    assert program  # the run did drive the program


def test_reference_and_yardstick_load_nothing_of_the_program():
    bad, program = _probe(
        "import perfbench.reference, perfbench.yardstick, perfbench.traffic")
    assert bad == [] and program == []
