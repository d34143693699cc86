"""The port's host oracles (ops/golden.py) against the JAX package's on
the CPU: each of the bit-flag SPA, dense-row and ESC oracles must give
the JAX one's CSR exactly (explicit zeros included: an entry whose
products cancel stays stored), on the tests/fixtures matrices and on
random ones; rows_match_oracle must give the same verdicts."""

import glob
import os

import numpy as np
import pytest

import spgemm_tpu
from spgemm_tpu.io.mmio import read_mtx as jread_mtx
from spgemm_tpu.ops import golden as jgolden

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import golden

FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                         "fixtures", "*.mtx")))
ORACLES = ("spgemm_spa_bitflag", "spgemm_dense_row", "spgemm_esc",
           "spgemm_scipy")


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def assert_same_csr(got, exp):
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got.indptr, exp.indptr)
    np.testing.assert_array_equal(got.indices, exp.indices)
    np.testing.assert_array_equal(got.data, exp.data)


def cancelling(seed, m=60, k=50, n=70, nnz=400):
    """Random integer values of both signs: many entries of C cancel to
    a stored zero."""
    r = np.random.default_rng(seed)
    mk = lambda m_, n_: spgemm_tpu.CSR.from_coo(
        r.integers(0, m_, nnz), r.integers(0, n_, nnz),
        r.integers(-2, 3, nnz).astype(np.float64), (m_, n_))
    return mk(m, k), mk(k, n)


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p) for p in FIXTURES])
def test_oracles_match_jax_on_fixtures(path, oracle):
    a, _ = jread_mtx(path)
    pa, _ = pt.read_mtx(path)
    assert_same_csr(pa, a)
    assert_same_csr(getattr(golden, oracle)(pa, pa),
                    getattr(jgolden, oracle)(a, a))


@pytest.mark.parametrize("oracle", ORACLES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracles_match_jax_on_random(oracle, seed):
    a, b = cancelling(seed)
    got = getattr(golden, oracle)(to_port(a), to_port(b))
    exp = getattr(jgolden, oracle)(a, b)
    assert_same_csr(got, exp)
    if oracle != "spgemm_scipy":
        assert (got.data == 0).any()   # cancelled entries stay stored
        assert_same_csr(golden.drop_explicit_zeros(got),
                        golden.spgemm_scipy(to_port(a), to_port(b)))


def test_row_blocks_split_large_products():
    # a budget far below the product count: many blocks, same C
    a, b = cancelling(3, m=200, k=40, n=300, nnz=3000)
    pa, pb = to_port(a), to_port(b)
    assert golden._row_blocks(pa, pb, budget=64) == jgolden._row_blocks(
        a, b, budget=64)
    assert len(golden._row_blocks(pa, pb, budget=64)) > 10


def test_empty_and_mismatched():
    e = spgemm_tpu.CSR.from_coo(np.zeros(0), np.zeros(0), np.zeros(0),
                                (8, 8))
    for oracle in ORACLES:
        assert_same_csr(getattr(golden, oracle)(to_port(e), to_port(e)),
                        getattr(jgolden, oracle)(e, e))
        with pytest.raises(ValueError, match="dimension mismatch"):
            getattr(golden, oracle)(to_port(e), pt.CSR.from_coo(
                [0], [0], [1.0], (5, 5)))


def test_rows_match_oracle_matches_jax():
    a, b = cancelling(4, m=80, k=80, n=80, nnz=600)
    pa, pb = to_port(a), to_port(b)
    c = golden.spgemm_esc(pa, pb)
    rows = np.array([0, 3, 17, 42, 79])
    assert golden.rows_match_oracle(c, pa, pb, rows)
    assert jgolden.rows_match_oracle(jgolden.spgemm_esc(a, b), a, b, rows)
    lo, hi = int(c.indptr[17]), int(c.indptr[18])
    bad = c.data.copy()
    bad[lo] += 1.0
    assert hi > lo
    assert not golden.rows_match_oracle(c.with_data(bad), pa, pb, rows)
    jc = jgolden.spgemm_esc(a, b)
    assert not jgolden.rows_match_oracle(jc.with_data(bad), a, b, rows)
