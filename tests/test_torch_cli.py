"""The port's CLI and package boundary on the CPU: same stdout contract
and verdict as the JAX package's CLI, for every backend it takes, and no
JAX loaded by `import spgemm_tpu_torch`."""

import os
import subprocess
import sys

import pytest

import numpy as np

from spgemm_tpu.cli import main as j_main
from spgemm_tpu.io.mmio import write_mtx
from spgemm_tpu.utils.generators import banded, random_uniform

from spgemm_tpu_torch.cli import main as p_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def mtx_file(tmp_path, make_random_csr):
    a = make_random_csr(120, 120, 0.05)
    p = tmp_path / "a.mtx"
    write_mtx(p, a)
    return str(p)


def _line_heads(out: str) -> list[str]:
    return [ln.split(":")[0] for ln in out.strip().splitlines()]


@pytest.mark.parametrize("aat", ["0", "1"])
def test_cli_matches_jax_contract(mtx_file, capsys, aat):
    args = ["-aat", aat, mtx_file, "16", "128", "--backend", "strip"]
    assert j_main(args) == 0
    j_out = capsys.readouterr().out
    assert p_main(["-d", "cpu"] + args) == 0
    p_out = capsys.readouterr().out
    assert "[PASSED]" in p_out and "GFLOPS" in p_out and "nnzCub" in p_out
    assert _line_heads(p_out) == _line_heads(j_out)
    # same C: the nnz(C) and numtile(C) lines agree
    pick = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith(("nnz(C)", "numtile(C)", "nnzCub"))]
    assert pick(p_out) == pick(j_out)


def test_cli_refuses_f64_and_nonsquare(mtx_file, tmp_path, make_random_csr,
                                       capsys):
    # f64 on a structured pattern with non-integer values runs the Ozaki
    # route, through auto routing and through --backend ozaki, and gives
    # the JAX CLI's C
    band = banded(np.random.default_rng(3), 300, 20)
    pb = tmp_path / "band.mtx"
    write_mtx(pb, band.with_data(band.data + 0.5))
    pick = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith(("nnz(C)", "numtile(C)", "nnzCub"))]
    for extra in (["--dtype", "f64"],
                  ["--backend", "ozaki", "--dtype", "f64"]):
        assert j_main([str(pb)] + extra) == 0
        j_out = capsys.readouterr().out
        assert p_main(["-d", "cpu", str(pb)] + extra) == 0
        p_out = capsys.readouterr().out
        assert "[PASSED]" in p_out and "numtile(C): 0" not in p_out
        assert _line_heads(p_out) == _line_heads(j_out)
        assert pick(p_out) == pick(j_out)
    p = tmp_path / "r.mtx"
    write_mtx(p, make_random_csr(60, 40, 0.08))
    assert p_main(["-d", "cpu", str(p)]) == 2
    # the pair kernel is float32 only, as the JAX package's is
    assert p_main(["-d", "cpu", str(pb), "--backend", "pallas", "--dtype",
                   "f64"]) == 2
    # the JAX CLI's backend list: an unknown name is refused by argparse
    with pytest.raises(SystemExit):
        p_main(["-d", "cpu", mtx_file, "--backend", "nope"])


@pytest.mark.parametrize("backend", ["gustavson", "dense"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cli_fallback_backends_match_jax(mtx_file, capsys, backend, dtype):
    """--backend gustavson|dense at TileSpGEMM's 16x16 tiles: the JAX
    CLI's lines and C (f64 on non-integer values runs the route in
    float64 in both)."""
    args = [mtx_file, "16", "16", "--backend", backend, "--dtype", dtype]
    assert j_main(args) == 0
    j_out = capsys.readouterr().out
    assert p_main(["-d", "cpu"] + args) == 0
    p_out = capsys.readouterr().out
    assert "[PASSED]" in p_out
    assert _line_heads(p_out) == _line_heads(j_out)
    pick = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith(("nnz(C)", "numtile(C)", "nnzCub"))]
    assert pick(p_out) == pick(j_out)


@pytest.mark.parametrize("extra", [["--backend", "esc"], ["--dtype", "f64"],
                                   ["--backend", "esc", "--dtype", "f64"]])
def test_cli_esc_and_f64_match_jax(tmp_path, capsys, extra):
    a = random_uniform(np.random.default_rng(4), 1500, 4)  # routes to ESC
    a = a.with_data(np.random.default_rng(5).standard_normal(a.nnz))
    p = tmp_path / "u.mtx"
    write_mtx(p, a)
    args = [str(p)] + extra
    assert j_main(args) == 0
    j_out = capsys.readouterr().out
    assert p_main(["-d", "cpu"] + args) == 0
    p_out = capsys.readouterr().out
    assert "[PASSED]" in p_out and "numtile(C): 0" in p_out
    assert _line_heads(p_out) == _line_heads(j_out)
    pick = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith(("nnz(C)", "numtile(C)", "nnzCub"))]
    assert pick(p_out) == pick(j_out)


@pytest.mark.parametrize("extra", [["--backend", "pallas"],
                                   ["--backend", "xla"],
                                   ["--backend", "xla", "--dtype", "f64"]])
def test_cli_pair_backends_match_jax(mtx_file, capsys, extra):
    args = [mtx_file, "16", "128"] + extra
    assert j_main(args) == 0
    j_out = capsys.readouterr().out
    assert p_main(["-d", "cpu"] + args) == 0
    p_out = capsys.readouterr().out
    assert "[PASSED]" in p_out
    assert _line_heads(p_out) == _line_heads(j_out)
    pick = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith(("nnz(C)", "numtile(C)", "nnzCub"))]
    assert pick(p_out) == pick(j_out)


def test_cli_csv_sinks(mtx_file, tmp_path, capsys):
    d = str(tmp_path / "csv")
    for rows in (2, 3):  # a second run appends without a second header
        assert p_main(["-d", "cpu", mtx_file, "16", "128", "--backend",
                       "strip", "--csv-dir", d]) == 0
        for f in ("results_tile.csv", "step_runtime.csv", "mem-cost.csv",
                  "preprocessing.csv"):
            with open(os.path.join(d, f)) as fh:
                assert len(fh.read().strip().splitlines()) == rows


def test_import_loads_no_jax():
    code = ("import sys, spgemm_tpu_torch, spgemm_tpu_torch.cli, "
            "spgemm_tpu_torch.ops.executor, spgemm_tpu_torch.utils.generators, "
            "spgemm_tpu_torch.ops.esc, spgemm_tpu_torch.ops.scan_kernels, "
            "spgemm_tpu_torch.ops.ozaki, spgemm_tpu_torch.ops.ozaki_kernels, "
            "spgemm_tpu_torch.ops.spmm, spgemm_tpu_torch.ops.spmm_kernels, "
            "spgemm_tpu_torch.ops.symbolic, spgemm_tpu_torch.ops.numeric, "
            "spgemm_tpu_torch.ops.pair_kernels;"
            " bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'spgemm_tpu', 'ml_dtypes')];"
            " assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_module_entry_point(mtx_file):
    res = subprocess.run(
        [sys.executable, "-m", "spgemm_tpu_torch", "-d", "cpu", mtx_file,
         "16", "128", "--backend", "strip"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "check (values vs scipy oracle): [PASSED]" in res.stdout
