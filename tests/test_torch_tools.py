"""The port's measurement and verification tools and the names they call,
held to the JAX package on the same seeded inputs (CPU):

* StripArgs.traffic_bytes equal to the JAX plan's, windowed and cached;
* the card timers (time_ozaki_strip, time_esc_scan_dd,
  device_ms_esc_scan_dd) raise without a card;
* utils/native.py:last_scan_build_stages set after a native build, with
  the JAX binding's keys;
* `python -m spgemm_tpu_torch.bench`, `...tools.verify_cuda` and the
  three probes exit 1 without a card, and no tool module imports jax;
* run_suite -d cpu: the nnzC/nnzCub/check columns equal the JAX runner's
  (`tools/run_suite.py`, run in this process on JAX's CPU);
* generate_fixtures: byte for byte the JAX generator's files;
* scale_suite -d cpu: the partition columns and checks equal the JAX
  tool's on its virtual mesh; the modelled compute column too;
* the two plan profilers: F and nnzC equal scipy's, a stage split.
"""

import csv
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from spgemm_tpu.models.csr import CSR as JCSR
from spgemm_tpu.models.tile import csr_to_tiles as j_csr_to_tiles
from spgemm_tpu.ops.gustavson import build_strip_args as j_build_strip_args
from spgemm_tpu_torch.models.tile import csr_to_tiles
from spgemm_tpu_torch.ops.gustavson import build_strip_args
from spgemm_tpu_torch.utils.generators import banded, cantlike

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL_MODULES = ["spgemm_tpu_torch.bench"] + [
    f"spgemm_tpu_torch.tools.{m}" for m in (
        "run_suite", "verify_cuda", "profile_esc_plan", "profile_aat_plan",
        "generate_fixtures", "scale_suite", "probe_dyngather", "probe_sort",
        "probe_primitives")]
PROBE_MODULES = [f"spgemm_tpu_torch.tools.{m}" for m in (
    "probe_dyngather", "probe_sort", "probe_primitives")]


def _reference_tool(name):
    """The JAX package's tools/<name>.py as a module (it imports jax)."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jcsr(a):
    return JCSR(a.indptr, a.indices, a.data, a.shape)


@pytest.mark.parametrize("window", [None, False])
@pytest.mark.parametrize("tm,rows", [(64, 3000), (16, 2000)])
def test_traffic_bytes_equal_jax(window, tm, rows):
    a = cantlike(rows, 64)
    p = build_strip_args(csr_to_tiles(a, tm, 128), csr_to_tiles(a, 128, 128),
                         32, window=window)
    ja = _jcsr(a)
    j = j_build_strip_args(j_csr_to_tiles(ja, tm, 128),
                           j_csr_to_tiles(ja, 128, 128), 32, window=window)
    assert (p.kwin is None) == (window is False)
    got = p.traffic_bytes()
    assert set(got) == {"a", "b", "c", "compact", "total"}
    assert got == j.traffic_bytes()
    assert got["total"] == got["a"] + got["b"] + got["c"] + got["compact"]


def test_card_timers_raise_off_cuda():
    import torch

    from spgemm_tpu_torch.models.csr import CSR
    from spgemm_tpu_torch.ops.esc import (build_esc_scan_plan,
                                          device_ms_esc_scan_dd,
                                          time_esc_scan_dd)
    from spgemm_tpu_torch.ops.ozaki import build_ozaki_strip, time_ozaki_strip

    a = banded(np.random.default_rng(0), 512, 16)
    plan = build_ozaki_strip(csr_to_tiles(a, 32, 128),
                             csr_to_tiles(a, 128, 128))
    with pytest.raises(RuntimeError):
        time_ozaki_strip(plan, device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        time_ozaki_strip(plan, device=None)
    rng = np.random.default_rng(7)
    r = CSR.from_coo(rng.integers(0, 256, 2048), rng.integers(0, 256, 2048),
                     rng.integers(1, 10, 2048).astype(np.float64), (256, 256))
    sp = build_esc_scan_plan(r, r)
    with pytest.raises(RuntimeError):
        time_esc_scan_dd(sp, r.data, r.data)
    with pytest.raises(RuntimeError):
        device_ms_esc_scan_dd(sp, r.data, r.data)


def test_last_scan_build_stages_has_reference_keys():
    import spgemm_tpu.utils.native as jnv
    from spgemm_tpu_torch.utils import native as nv
    from spgemm_tpu_torch.utils.generators import rmat

    a = rmat(np.random.default_rng(3), 2048)
    assert nv.esc_scan_symbolic_native(a, a, keep_sources=False) is not None
    stages = nv.last_scan_build_stages
    assert jnv.esc_scan_symbolic_native(_jcsr(a), _jcsr(a),
                                        keep_sources=False) is not None
    assert list(stages) == list(jnv.last_scan_build_stages) == [
        "walk", "extract", "layout", "scatter", "flush"]
    assert all(isinstance(v, int) and v >= 0 for v in stages.values())
    assert sum(stages.values()) > 0


def _no_card_env():
    return {**os.environ, "CUDA_VISIBLE_DEVICES": ""}


@pytest.mark.parametrize("module", ["spgemm_tpu_torch.bench",
                                    "spgemm_tpu_torch.tools.verify_cuda"]
                         + PROBE_MODULES)
def test_entry_points_exit_1_without_a_card(module):
    p = subprocess.run([sys.executable, "-m", module], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=_no_card_env())
    assert p.returncode == 1, p.stderr
    assert "no CUDA device" in p.stderr
    assert p.stdout == ""          # no result line, no FAILS line


def test_tool_modules_import_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in TOOL_MODULES)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'spgemm_tpu' or "
              "m.startswith('spgemm_tpu.')]\n"
              "print(bad)\nsys.exit(1 if bad else 0)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr


def _rows(path):
    with open(path) as f:
        return {(r["matrix"], r["config"]): r for r in csv.DictReader(f)}


def test_run_suite_columns_equal_jax_runner(tmp_path):
    from spgemm_tpu_torch.tools import run_suite

    ours, theirs = tmp_path / "port", tmp_path / "jax"
    args = ["--n", "512", "--configs", "A2,AAT"]
    assert run_suite.main(args + ["-d", "cpu", "--outdir", str(ours)]) == 0
    assert _reference_tool("run_suite").main(
        args + ["--no-prewarm", "--outdir", str(theirs)]) == 0
    got = _rows(ours / "suite_summary.csv")
    exp = _rows(theirs / "suite_summary.csv")
    assert set(got) == set(exp) and len(got) == 10
    for key, row in got.items():
        for col in ("nnzC", "nnzCub", "check", "backend"):
            assert row[col] == exp[key][col], (key, col)
        assert row["check"] == "PASSED" and row["dtype"] == "f32"
    for sink in ("results_tile", "step_runtime", "mem-cost", "preprocessing"):
        with open(ours / f"{sink}.csv") as f:
            assert len(f.readlines()) == 11, sink


def test_run_suite_without_a_card_raises(tmp_path):
    import torch

    from spgemm_tpu_torch.tools import run_suite

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            run_suite.main(["--n", "512", "--outdir", str(tmp_path)])


def test_generate_fixtures_equal_reference(tmp_path, capsys):
    from spgemm_tpu_torch.tools import generate_fixtures

    generate_fixtures.main(str(tmp_path / "port"))
    _reference_tool("generate_fixtures").main(str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 14
    for name in names:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
        assert ((tmp_path / "port" / name).read_bytes()
                == open(os.path.join(ROOT, "tests", "fixtures", name),
                        "rb").read()), name


def test_scale_suite_equals_jax_tool(tmp_path):
    from spgemm_tpu_torch.tools import scale_suite

    args = ["--n", "512", "--devs", "2", "--anchor-ms", "0.05"]
    assert scale_suite.main(args + ["-d", "cpu", "--out",
                                    str(tmp_path / "port.csv")]) == 0
    assert _reference_tool("scale_suite").main(
        args + ["--cpu", "--out", str(tmp_path / "jax.csv")]) == 0
    with open(tmp_path / "port.csv") as f:
        got = list(csv.DictReader(f))
    with open(tmp_path / "jax.csv") as f:
        exp = list(csv.DictReader(f))
    assert len(got) == len(exp) == 2
    for g, e in zip(got, exp):
        for col in ("devices", "variant", "pairs_max", "pairs_mean",
                    "balance", "check"):
            assert g[col] == e[col], col
        assert g["modelled_compute_ms"] == e["model_compute_ms"]


def test_scale_suite_cpu_needs_anchor(tmp_path):
    from spgemm_tpu_torch.tools import scale_suite

    with pytest.raises(SystemExit):
        scale_suite.main(["--n", "256", "--devs", "1", "-d", "cpu",
                          "--out", str(tmp_path / "x.csv")])


def test_plan_profilers(capsys):
    from spgemm_tpu_torch.models.csr import flop_count_spgemm
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.tools import profile_aat_plan, profile_esc_plan
    from spgemm_tpu_torch.utils.generators import rmat

    assert profile_esc_plan.main(["rmat2048"]) == 0
    out = capsys.readouterr().out
    a = rmat(np.random.default_rng(1234), 2048)
    assert f"F={flop_count_spgemm(a, a)} " in out
    assert f"nnzC={golden.spgemm_scipy(a, a).nnz} " in out
    assert "stage split:" in out and "walk=" in out and "flush=" in out
    assert profile_aat_plan.main(["rmat2048", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("build best") == 2 and "scatter=" in out
