"""Cross-backend fuzz of the PyTorch port (counterpart of
tests/test_fuzz.py): random shapes, tile sizes and densities through
every tiled backend on the CPU (the plain PyTorch versions), against the
scipy oracle (pattern and values) and against the JAX package's spgemm
on the same seeded inputs.

Tolerances are the reference's: rtol 1e-5, atol 1e-8 on the integer
value model (f32 sums of small integers are exact, so any loss is a
fault), and 1e-14*max|C| for the f64 Ozaki engine on Gaussian x 2^k
values. JAX's strip backend runs its Pallas kernel in interpret mode
(seconds a call), and so does its auto backend, which picks strip on the
CPU: only two cases compare with JAX on those two.
"""

import numpy as np
import pytest

from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import csr_to_tiles
from spgemm_tpu_torch.ops import golden
from spgemm_tpu_torch.ops.spgemm import spgemm

CASES = [
    # (m, k, n, density, tm, tn, seed): tests/test_fuzz.py's seven
    (64, 64, 64, 0.10, 8, 8, 0),
    (100, 50, 80, 0.08, 16, 16, 1),
    (33, 77, 55, 0.15, 8, 16, 2),
    (128, 128, 128, 0.02, 16, 32, 3),
    (200, 40, 200, 0.05, 8, 8, 4),
    (90, 90, 90, 0.30, 16, 16, 5),   # dense-ish
    (70, 130, 20, 0.07, 32, 16, 6),
]
BACKENDS = ["strip", "gustavson", "dense", "xla", "auto"]
JAX_STRIP_SEEDS = (1, 3)        # strip and auto cases also run through JAX


def _operands(case):
    m, k, n, density, _tm, _tn, seed = case
    rng = np.random.default_rng(seed)
    nnz_a = max(1, int(m * k * density))
    nnz_b = max(1, int(k * n * density))
    a = CSR.from_coo(rng.integers(0, m, nnz_a), rng.integers(0, k, nnz_a),
                     rng.integers(-4, 5, nnz_a).astype(np.float64), (m, k))
    b = CSR.from_coo(rng.integers(0, k, nnz_b), rng.integers(0, n, nnz_b),
                     rng.integers(-4, 5, nnz_b).astype(np.float64), (k, n))
    return a, b


def _jax_c(a, b, tm, tn, backend):
    """C of the JAX package's spgemm on the same operands, as port CSR.
    JAX is imported here, not at the top: tests/test_torch_cuda.py takes
    CASES and _operands from this file and imports no JAX."""
    from spgemm_tpu.models.csr import CSR as JCSR
    from spgemm_tpu.models.tile import csr_to_tiles as j_csr_to_tiles
    from spgemm_tpu.ops.spgemm import spgemm as j_spgemm

    ja = JCSR(a.indptr, a.indices, a.data, a.shape)
    jb = JCSR(b.indptr, b.indices, b.data, b.shape)
    res = j_spgemm(j_csr_to_tiles(ja, tm, tn), j_csr_to_tiles(jb, tn, tn),
                   backend=backend)
    c = res.c.to_csr()
    return golden.drop_explicit_zeros(
        CSR(c.indptr, c.indices, np.asarray(c.data, np.float64), c.shape))


def _check(got, ref, what):
    assert got.pattern_equal(ref), f"{what}: pattern mismatch"
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5, atol=1e-8,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES, ids=[f"c{c[-1]}" for c in CASES])
@pytest.mark.parametrize("backend", BACKENDS)
def test_fuzz_backend_vs_oracle_and_jax(case, backend):
    a, b = _operands(case)
    tm, tn = case[4], case[5]
    res = spgemm(csr_to_tiles(a, tm, tn), csr_to_tiles(b, tn, tn),
                 backend=backend, device="cpu")
    got = golden.drop_explicit_zeros(res.c.to_csr())
    _check(got, golden.spgemm_scipy(a, b), f"{backend} vs scipy on {case}")
    if backend not in ("strip", "auto") or case[-1] in JAX_STRIP_SEEDS:
        _check(got, _jax_c(a, b, tm, tn, backend),
               f"{backend} vs JAX on {case}")


def _check_auto(a):
    res = spgemm(csr_to_tiles(a, 16, 16), csr_to_tiles(a, 16, 16),
                 backend="auto", device="cpu")
    got = golden.drop_explicit_zeros(res.c.to_csr())
    ref = golden.spgemm_scipy(a, a)
    assert got.allclose(ref, rtol=1e-5)
    _check(got, _jax_c(a, a, 16, 16, "auto"), "auto vs JAX")


def test_adversarial_holey_band():
    """Empty block ranges in the middle of the matrix (windowed-B kmin
    defaults for empty blocks)."""
    rng = np.random.default_rng(3)
    n = 400
    offs = np.arange(-5, 6)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n) & ~((r > n * 0.3) & (r < n * 0.6))
    _check_auto(CSR.from_coo(
        r[keep], c[keep],
        rng.integers(1, 9, keep.sum()).astype(float), (n, n)))


def test_adversarial_antidiagonal():
    """k decreasing with row: stresses per-block k-window minima."""
    rng = np.random.default_rng(4)
    n = 300
    r = np.repeat(np.arange(n), 5)
    c = (n - 1 - r) + np.tile(np.arange(-2, 3), n)
    m = (c >= 0) & (c < n)
    _check_auto(CSR.from_coo(
        r[m], c[m], rng.integers(1, 9, m.sum()).astype(float), (n, n)))


@pytest.mark.parametrize("case", CASES, ids=[f"c{c[-1]}" for c in CASES])
def test_fuzz_ozaki_vs_oracle(case):
    """The Ozaki f64 engine on random shapes and patterns with general f64
    values (Gaussian x 2^k spread): within 1e-14*max|C| of scipy. Tiles
    at the slab layout's (16, 128)."""
    m, k, n, density, _tm, _tn, seed = case
    rng = np.random.default_rng(1000 + seed)
    nnz_a = max(1, int(m * k * density))
    nnz_b = max(1, int(k * n * density))

    def vals(c):
        return rng.standard_normal(c) * np.exp2(
            rng.integers(-8, 9, c).astype(np.float64))

    a = CSR.from_coo(rng.integers(0, m, nnz_a), rng.integers(0, k, nnz_a),
                     vals(nnz_a), (m, k))
    b = CSR.from_coo(rng.integers(0, k, nnz_b), rng.integers(0, n, nnz_b),
                     vals(nnz_b), (k, n))
    res = spgemm(csr_to_tiles(a, 16, 128), csr_to_tiles(b, 128, 128),
                 backend="ozaki", device="cpu")
    ref = golden.spgemm_scipy(a, b)
    got = golden.drop_explicit_zeros(res.c.to_csr())
    assert got.pattern_equal(ref), f"ozaki pattern mismatch on {case}"
    scale = max(np.abs(ref.data).max() if ref.nnz else 1.0, 1e-300)
    assert np.abs(got.data - ref.data).max() <= 1e-14 * scale, \
        f"ozaki values on {case}"
