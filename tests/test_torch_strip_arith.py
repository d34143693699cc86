"""The strip kernel's arithmetic, emulated in plain torch on the CPU.

`csrc/strip_numeric.cu` multiplies f32 values on the tensor cores as
3xTF32: each operand x splits into hi = rna_tf32(x) and lo =
rna_tf32(x - hi), and the f32 accumulator takes lo_a.hi_b + hi_a.lo_b +
hi_a.hi_b. The emulation here rounds to TF32 by bit masking (round to
nearest, ties away from zero, as cvt.rna does), forms the three products
in f32 (each TF32 x TF32 product is exact in f32) and holds the result to
the tolerance the kernel is checked at on the card: rtol 1e-5, atol
1e-6*max|C| of an f64 product, at tk = 128, on Gaussian values spanning
1e-3..1e3. TF32 alone must miss that tolerance, or the test would not
tell the two apart. Integer values below 2^11 split with lo = 0, which is
what lets the kernel skip the lo products and stay bit-equal to the
plain f32 version on the integer value model.
"""

import numpy as np
import pytest
import torch

from spgemm_tpu_torch.ops import kernels

RTOL, ATOL_REL = 1e-5, 1e-6


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32 (10 explicit mantissa bits), nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def _wide_gaussian(rng, shape):
    """Standard-normal values scaled to magnitudes spanning 1e-3..1e3."""
    return (rng.standard_normal(shape)
            * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)


def _within(got, exp):
    scale = np.abs(exp).max()
    return np.abs(got - exp) <= RTOL * np.abs(exp) + ATOL_REL * scale


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 spacing at 1.0
    x = torch.tensor([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), 3.0, 0.0], dtype=torch.float32)
    exp = torch.tensor([one, one + ulp, one + ulp, -(one + ulp), 3.0, 0.0])
    assert torch.equal(rna_tf32(x), exp)
    hi, lo = split_tf32(torch.tensor([1.0 + 2.0 ** -20]))
    assert hi.item() == 1.0 and lo.item() == 2.0 ** -20


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_3xtf32_within_kernel_tolerance(tm, seed):
    rng = np.random.default_rng(seed)
    a = _wide_gaussian(rng, (tm, 128))
    b = _wide_gaussian(rng, (128, 128))
    exp = a.astype(np.float64) @ b.astype(np.float64)
    got = product_3xtf32(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert _within(got, exp).all()
    tf32 = (rna_tf32(torch.from_numpy(a)) @ rna_tf32(torch.from_numpy(b)))
    assert not _within(tf32.numpy(), exp).all()


def test_3xtf32_sums_over_many_pairs():
    # a C slot sums several (A tile, B slice) products: k = 4 x 128
    rng = np.random.default_rng(3)
    a = _wide_gaussian(rng, (64, 512))
    b = _wide_gaussian(rng, (512, 128))
    exp = a.astype(np.float64) @ b.astype(np.float64)
    acc = torch.zeros(64, 128)
    for k0 in range(0, 512, 128):
        acc += product_3xtf32(torch.from_numpy(a[:, k0:k0 + 128]),
                              torch.from_numpy(b[k0:k0 + 128]))
    assert _within(acc.numpy(), exp).all()


def test_integers_split_with_zero_lo():
    x = torch.arange(-2047, 2048, dtype=torch.float32)
    hi, lo = split_tf32(x)
    assert torch.equal(hi, x) and not lo.any()
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.integers(1, 10, (64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.integers(1, 10, (128, 128)).astype(np.float32))
    ah, _ = split_tf32(a)
    bh, _ = split_tf32(b)
    assert torch.equal(ah @ bh, a @ b)


def test_ptxas_usage_parses_registers_and_spills():
    log = ("ptxas info    : Compiling entry function '_Z1fILi64EEvv' for "
           "'sm_90a'\n"
           "ptxas info    : Function properties for _Z1fILi64EEvv\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 128 registers, 432 bytes cmem[0]\n"
           "ptxas info    : Compiling entry function '_Z1gv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1gv\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 40 registers, 432 bytes cmem[0]\n")
    assert kernels.ptxas_usage(log) == {"_Z1fILi64EEvv": (128, 8, 4),
                                        "_Z1gv": (40, 0, 0)}
