"""The port's Matrix Market writer and .npz checkpoints against the JAX
package's: write_mtx must write the same bytes, and a checkpoint written
by either package must load in the other, array for array."""

import numpy as np
import pytest

import spgemm_tpu
from spgemm_tpu.io import checkpoint as jckpt
from spgemm_tpu.io.mmio import write_mtx as jwrite_mtx
from spgemm_tpu.models.tile import csr_to_tiles as jcsr_to_tiles

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.io import checkpoint, write_mtx

TILE_FIELDS = ("trow", "tcol", "tptr", "tnnz_ptr", "rc", "val", "mask",
               "rowptr")


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def assert_same_csr(got, exp):
    assert got.shape == exp.shape
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f))


def assert_same_tiles(got, exp):
    assert (got.shape, got.tm, got.tn) == (exp.shape, exp.tm, exp.tn)
    for f in TILE_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f),
                                      err_msg=f)


@pytest.mark.parametrize("comment", ["", "two\nlines"])
def test_write_mtx_bytes_match_jax(make_random_csr, tmp_path, comment):
    a = make_random_csr(40, 30, 0.1, integer_vals=False)
    jwrite_mtx(tmp_path / "j.mtx", a, comment=comment)
    write_mtx(tmp_path / "p.mtx", to_port(a), comment=comment)
    assert (tmp_path / "p.mtx").read_bytes() == (
        tmp_path / "j.mtx").read_bytes()
    back, sym = pt.read_mtx(tmp_path / "p.mtx")
    assert not sym
    assert_same_csr(back, to_port(a))   # %.17g round-trips f64 exactly


def test_write_mtx_empty(tmp_path):
    e = spgemm_tpu.CSR.from_coo(np.zeros(0), np.zeros(0), np.zeros(0),
                                (5, 7))
    jwrite_mtx(tmp_path / "j.mtx", e)
    write_mtx(tmp_path / "p.mtx", to_port(e))
    assert (tmp_path / "p.mtx").read_bytes() == (
        tmp_path / "j.mtx").read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_csr_checkpoint_loads_across_packages(make_random_csr, tmp_path,
                                              writer):
    a = make_random_csr(50, 60, 0.1, integer_vals=False)
    path = tmp_path / "a.npz"
    if writer == "port":
        checkpoint.save(path, to_port(a))
    else:
        jckpt.save(path, a)
    got, exp = checkpoint.load(path), jckpt.load(path)
    assert isinstance(got, pt.CSR)
    assert_same_csr(got, a)
    assert_same_csr(exp, a)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tilemat_checkpoint_loads_across_packages(make_random_csr,
                                                  tmp_path, writer):
    a = make_random_csr(70, 90, 0.08)
    jt = jcsr_to_tiles(a, 16, 32)
    pt_t = pt.csr_to_tiles(to_port(a), 16, 32)
    assert_same_tiles(pt_t, jt)
    path = tmp_path / "t.npz"
    if writer == "port":
        checkpoint.save_tilemat(path, pt_t)
    else:
        jckpt.save_tilemat(path, jt)
    got, exp = checkpoint.load(path), jckpt.load(path)
    assert isinstance(got, pt.TileMat)
    assert_same_tiles(got, jt)
    assert_same_tiles(exp, jt)


def test_checkpoint_refusals(tmp_path):
    with pytest.raises(TypeError, match="cannot checkpoint"):
        checkpoint.save(tmp_path / "x.npz", object())
    np.savez_compressed(tmp_path / "v.npz", kind="csr", version=2)
    with pytest.raises(ValueError, match="version 2"):
        checkpoint.load(tmp_path / "v.npz")
    np.savez_compressed(tmp_path / "k.npz", kind="coo", version=1)
    with pytest.raises(ValueError, match="unknown checkpoint kind"):
        checkpoint.load(tmp_path / "k.npz")
