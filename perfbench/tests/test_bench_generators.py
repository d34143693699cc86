"""The generators of the benchmark's matrices and traffic: sizes,
symmetry, the element stiffness, and the relabelling's isomorphism."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conftest import full_config, small_config
from perfbench import harness, yardstick
from perfbench.matrices import top3d


def _matrix(cfg):
    return harness.load_module("matrices", cfg["generator"]).build(cfg)


def _traffic(bench, name, seed, config):
    return harness.open_cell(bench, name, seed, "cpu", config)[-1]


def test_top3d_sizes_exact(bench):
    cfg = full_config(bench, "top3d.a2")
    m = _matrix(cfg)
    sizes = cfg["sizes"]
    assert m.shape == (sizes["rows"], sizes["rows"]) == (58590, 58590)
    assert m.indices.size == sizes["nnz"] == 4170348
    assert yardstick.nnz_cub(m.indptr, m.indices, m.indptr) == \
        sizes["nnz_cub"]
    a = sp.csr_matrix((np.ones(m.indices.size), m.indices, m.indptr),
                      shape=m.shape)
    assert (a @ a).nnz == sizes["nnz_c"] == 17266716


def test_element_stiffness():
    ke, corners = top3d.element_stiffness(0.3)
    assert np.abs(ke - ke.T).max() < 1e-15
    assert np.all(ke != 0)
    eig = np.linalg.eigvalsh(ke)
    assert np.all(np.abs(eig[:6]) < 1e-12) and eig[6] > 1e-2  # rigid modes
    for d in range(3):  # a rigid translation stores no energy
        u = np.zeros(24)
        u[d::3] = 1.0
        assert np.abs(ke @ u).max() < 1e-14
    # a uniform stretch along x: stress lam + 2 mu over the unit cube
    lam, mu = 0.3 / (1.3 * 0.4), 1 / 2.6
    u = np.zeros(24)
    u[0::3] = corners[:, 0]
    assert u @ ke @ u == pytest.approx(lam + 2 * mu)


def test_top3d_assembly_against_a_plain_loop():
    cfg = {"nelx": 3, "nely": 2, "nelz": 2, "nu": 0.3, "penal": 3.0,
           "E0": 1.0, "Emin": 1e-9}
    m = top3d.build(cfg)
    g = torch.Generator().manual_seed(5)
    vals = m.values(g, torch.float64).numpy()
    x = torch.rand(12, generator=torch.Generator().manual_seed(5),
                   dtype=torch.float64).numpy()
    ke, corners = top3d.element_stiffness(0.3)
    nelx, nely, nelz = 3, 2, 2
    n_dof = 3 * 4 * 3 * 3
    k = np.zeros((n_dof, n_dof))
    e = 0
    for i in range(nelx):      # the meshgrid's order: x, then y, then z
        for j in range(nely):
            for kk in range(nelz):
                nodes = [(kk + cz) * 12 + (i + cx) * 3 + (nely - j - cy)
                         for cx, cy, cz in corners]
                dofs = [3 * nd + d for nd in nodes for d in range(3)]
                k[np.ix_(dofs, dofs)] += (1e-9 + x[e] ** 3 * (1 - 1e-9)) * ke
                e += 1
    fixed = [3 * (kk * 12 + j) + d for kk in range(3) for j in range(3)
             for d in range(3)]
    free = np.setdiff1d(np.arange(n_dof), fixed)
    got = sp.csr_matrix((vals, m.indices, m.indptr), shape=m.shape)
    np.testing.assert_allclose(got.toarray(), k[np.ix_(free, free)],
                               rtol=0, atol=1e-15)
    assert np.linalg.eigvalsh(got.toarray()).min() > 0


def test_graph500_sizes_and_symmetry(bench):
    cfg = full_config(bench, "graph500_s14.a2")
    m = _matrix(cfg)
    n = m.shape[0]
    sizes = cfg["sizes"]
    assert n == sizes["vertices"] == 1 << cfg["scale"]
    assert m.indices.size == sizes["nnz"]
    assert yardstick.nnz_cub(m.indptr, m.indices, m.indptr) == \
        sizes["nnz_cub"]
    assert int(np.diff(m.indptr).max()) == sizes["max_degree"]
    rows = np.repeat(np.arange(n), np.diff(m.indptr))
    key = rows * n + m.indices
    assert np.all(np.diff(key) > 0)  # sorted, no duplicate
    assert np.array_equal(np.sort(m.indices.astype(np.int64) * n + rows),
                          key)


@pytest.mark.parametrize("call", [1, 7])
def test_relabel_is_isomorphic(bench, call):
    tr = _traffic(bench, "graph500_s14.a2", 2**31 + 5,
                  small_config(bench, "graph500_s14.a2"))
    base, new = tr.inputs(-1), tr.inputs(call)
    n = base.shape[0]
    perm = torch.randperm(n, generator=tr.generator("relabel", call)).numpy()
    rows = np.repeat(np.arange(n), np.diff(base.indptr))
    dense_base = np.zeros((n, n), np.float32)
    dense_base[rows, base.indices] = base.data
    dense_new = np.zeros((n, n), np.float32)
    dense_new[np.repeat(np.arange(n), np.diff(new.indptr)),
              new.indices] = new.data
    expect = np.zeros_like(dense_base)
    expect[np.ix_(perm, perm)] = dense_base
    assert np.array_equal(dense_new, expect)
    assert np.array_equal(dense_new, dense_new.T)  # symmetric weights
    assert new.nnz == base.nnz
    assert (yardstick.nnz_cub(new.indptr, new.indices, new.indptr)
            == yardstick.nnz_cub(base.indptr, base.indices, base.indptr))


@pytest.mark.parametrize("name", ["top3d.a2", "graph500_s14.a2"])
def test_inputs_repeat_for_a_seed_and_call(bench, name):
    cfg = small_config(bench, name)
    a, b, c = (_traffic(bench, name, s, cfg).inputs(call)
               for s, call in [(3, 4), (3, 4), (3, 5)])
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.data, b.data)
    # a fresh draw: new values (top3d) or a new labelling (graph500)
    assert not (np.array_equal(a.indices, c.indices)
                and np.array_equal(a.data, c.data))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["top3d.a2", "graph500_s14.a2"])
def test_inputs_in_the_configs_dtype(bench, name, dtype):
    cfg = dict(small_config(bench, name), dtype=dtype)
    tr = _traffic(bench, name, 2**33 + 1, cfg)
    for call in (-1, 2):
        assert tr.inputs(call).data.dtype == np.dtype(dtype)
