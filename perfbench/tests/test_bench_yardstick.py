"""The yardstick's counts and the plain reference on small matrices."""

import numpy as np
import pytest
import torch

from perfbench import reference, yardstick


def _random_csr(rng, m, n, nnz):
    key = np.unique(rng.integers(0, m * n, nnz))
    rows, cols = key // n, key % n
    indptr = np.zeros(m + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    data = rng.standard_normal(key.size).astype(np.float32)
    data[::7] = 0.0  # explicit zeros stay structural entries
    return indptr, cols.astype(np.int32), data


def _dense(indptr, indices, data, shape):
    d = np.zeros(shape)
    d[np.repeat(np.arange(shape[0]), np.diff(indptr)), indices] = data
    return d


def test_nnz_cub_and_bytes():
    rng = np.random.default_rng(0)
    ip, ix, _ = _random_csr(rng, 40, 40, 300)
    occ = _dense(ip, ix, np.ones(ix.size), (40, 40))
    assert yardstick.nnz_cub(ip, ix, ip) == int((occ @ occ).sum())
    assert yardstick.csr_bytes(40, 300, 4) == 300 * 8 + 41 * 4
    # C = A^2 reads its one operand once
    assert yardstick.spgemm_min_bytes(40, 300, 500, 4) == \
        (300 * 8 + 41 * 4) + 500 * 8 + 41 * 4
    assert yardstick.spgemm_min_bytes(40, 300, 500, 4, nnz_b=200) == \
        (300 * 8 + 41 * 4) + (200 * 8 + 41 * 4) + 500 * 8 + 41 * 4
    assert yardstick.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 495e12) == pytest.approx(1.0)


def test_reference_spgemm_against_dense():
    rng = np.random.default_rng(1)
    ip, ix, v = _random_csr(rng, 50, 50, 400)
    c_ip, c_ix, c_v, c_g = reference.spgemm(ip, ix, v, ip, ix, v, 50,
                                            device="cpu", max_products=97)
    a = _dense(ip, ix, v.astype(np.float64), (50, 50))
    occ = _dense(ip, ix, np.ones(ix.size), (50, 50))
    got = _dense(c_ip.numpy(), c_ix.numpy(), c_v.numpy(), (50, 50))
    pattern = _dense(c_ip.numpy(), c_ix.numpy(), np.ones(c_ix.numel()),
                     (50, 50))
    assert np.array_equal(pattern > 0, (occ @ occ) > 0)
    np.testing.assert_allclose(got, a @ a, rtol=0, atol=1e-12)
    mags = _dense(c_ip.numpy(), c_ix.numpy(), c_g.numpy(), (50, 50))
    np.testing.assert_allclose(mags, np.abs(a) @ np.abs(a), atol=1e-12)


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      1.0 + 2**-12, -3.0 - 2**-11], dtype=torch.float32)
    got = reference.round_tf32(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0],
                        dtype=torch.float32)
    assert torch.equal(got, want)
