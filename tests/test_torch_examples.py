"""The port's six example applications (spgemm_tpu_torch/examples) on
the CPU against the JAX package's (examples/*.py, loaded with runpy), at
tests/test_examples.py's sizes and the JAX defaults: the triangle count
equal, the AMG coarse operators within rtol 1e-5 (f32 sums in another
order), the MCL labels equal, the PageRank vector within 1e-6 (max abs;
ranks ~1e-5 summed in f32), the dominant eigenvalue within 1e-5
relative, and the serving loop's OK lines equal. Each port's own check
must pass (exit code 0)."""

import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

from spgemm_tpu.ops.spmm import spmm_gather as jspmm_gather
from spgemm_tpu.utils.generators import rmat as jrmat

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.examples import (amg_galerkin, markov_clustering,
                                       pagerank, power_method, serving_loop,
                                       triangle_counting)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def jax_example(script):
    """The JAX example's module namespace (its main does not run)."""
    return runpy.run_path(os.path.join(REPO, "examples", script),
                          run_name="x")


def run_jax_main(script, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [script] + argv)
    monkeypatch.chdir(REPO)
    runpy.run_path(os.path.join(REPO, "examples", script),
                   run_name="__main__")


@pytest.mark.parametrize("argv", [[], ["1000", "8"]])
def test_triangle_counting_matches_jax(argv, capsys):
    ns = jax_example("triangle_counting.py")
    n, deg = (int(v) for v in argv) if argv else (2000, 16)
    adj = ns["random_graph"](n, deg)
    exp = ns["count_triangles"](adj)
    got = triangle_counting.count_triangles(to_port(adj), device="cpu")
    assert got == exp
    assert triangle_counting.main(argv + ["--device", "cpu"]) == 0
    assert f"triangles: {exp}" in capsys.readouterr().out


@pytest.mark.parametrize("g,levels", [(32, 2), (128, 2)])
def test_amg_galerkin_matches_jax(g, levels):
    ns = jax_example("amg_galerkin.py")
    got = amg_galerkin.coarsen(g, levels, device="cpu")
    a = ns["poisson2d"](g)
    for lvl in range(levels):
        p = ns["aggregate_p"](g)
        ap, _ = ns["spgemm_csr"](a, p)
        rap, _ = ns["spgemm_csr"](p.transpose(), ap)
        exp = ns["golden"].drop_explicit_zeros(rap)
        assert got[lvl].pattern_equal(exp)
        np.testing.assert_allclose(got[lvl].data, exp.data, rtol=1e-5)
        a, g = exp, (g + 1) // 2
    assert amg_galerkin.main(["32", "2", "--device", "cpu"]) == 0


def test_markov_clustering_matches_jax():
    ns = jax_example("markov_clustering.py")
    adj = ns["clustered_graph"](1024)
    exp = ns["mcl"](adj)
    got = markov_clustering.mcl(to_port(adj), device="cpu")
    np.testing.assert_array_equal(got, exp)


def _jax_pagerank(g):
    """examples/pagerank.py's iteration, on the JAX package's gather SpMM."""
    n = g.n
    row_sum = np.zeros(n)
    np.add.at(row_sum, g.rows_expanded(), g.data)
    dangling = row_sum == 0
    p = type(g)(g.indptr, g.indices,
                g.data / np.maximum(row_sum, 1e-300)[g.rows_expanded()],
                g.shape).transpose()
    d, tol = 0.85, 1e-8
    x = np.full((n, 1), 1.0 / n, np.float32)
    for it in range(100):
        leak = d * float(x[dangling].sum())
        x_new = d * jspmm_gather(p, x) + (leak + 1 - d) / n
        delta = float(np.abs(x_new - x).sum())
        x = np.asarray(x_new)
        if delta < tol:
            break
    return x, it + 1


def test_pagerank_matches_jax():
    g = jrmat(np.random.default_rng(7), 16384, 16, values="ones")
    exp, exp_iters = _jax_pagerank(g)
    got, iters = pagerank.pagerank(to_port(g), device="cpu")
    assert iters == exp_iters
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6)
    assert abs(float(got.sum()) - 1.0) < 1e-3


def test_pagerank_main_checks_itself(capsys):
    assert pagerank.main(["2048", "8", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.rstrip().endswith("OK")


def test_power_method_matches_jax(monkeypatch, capsys):
    run_jax_main("power_method.py", [], monkeypatch)
    out = capsys.readouterr().out
    exp = float(re.search(r"power iteration\): ([-0-9.]+)", out).group(1))
    assert power_method.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = float(re.search(r"power iteration\): ([-0-9.]+)", out).group(1))
    assert abs(got - exp) <= 1e-5 * abs(exp)


def test_power_step_counts_one_launch_per_iteration():
    from spgemm_tpu_torch.ops import spmm_kernels

    a = power_method.banded_spd(1000, 4)
    before = spmm_kernels.spmm_strip.plain_launches
    lam, x, _ = power_method.power_iteration(a, iters=7, device="cpu")
    assert spmm_kernels.spmm_strip.plain_launches - before == 7
    # the same 7 steps in f64
    sa = a.to_dense()
    xr = np.full(1000, 1 / np.sqrt(1000))
    for _ in range(7):
        y = sa @ xr
        lam_r, xr = xr @ y, y / np.linalg.norm(y)
    assert abs(lam - lam_r) <= 1e-5 * abs(lam_r)
    np.testing.assert_allclose(x.numpy(), xr, rtol=0, atol=1e-6)


def _tick_lines(out):
    """(engine, tick, nnzC, verdict) of each tick line."""
    return re.findall(r"\[(\w+)\] +tick (\d+): [0-9.]+ ms nnzC=(\d+) (\w+)",
                      out)


def test_serving_loop_matches_jax(monkeypatch, capsys):
    run_jax_main("serving_loop.py", ["512", "1"], monkeypatch)
    exp = _tick_lines(capsys.readouterr().out)
    assert serving_loop.main(["512", "1", "--device", "cpu"]) == 0
    got = _tick_lines(capsys.readouterr().out)
    assert [e for e, *_ in got] == ["strip", "esc", "ozaki"]
    assert got == exp and all(v == "OK" for *_, v in got)
