"""The tensor-core kernels' arithmetic, emulated in plain torch on the CPU.

The strip and pair kernels run one tile pipeline (csrc/strip_numeric.cu,
copied into csrc/pair_accumulate.cu), and the 128-column SpMM kernel
(csrc/spmm_strip.cu) the same 3xTF32 products; the SpMM kernel splits each X chunk into hi/lo planes once, for
all warps, and skips the products whose lo operand is zero throughout
(lo_a.hi_b where A is made of TF32 values, hi_a.lo_b where X is). Adding
those zero products changes no accumulator, so the skipped and the full
sums agree bit for bit; the tests below hold both at the SpMM and pair
shapes.

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


def _accumulate_3xtf32(a_tiles, b_tiles, skip_zero_lo):
    """sum_t a_tiles[t] @ b_tiles[t], each product added into the f32
    accumulator term by term (lo_a.hi_b, hi_a.lo_b, hi_a.hi_b), as the
    kernels' mma.sync steps do; B split once per tile (the SpMM kernel's
    hi/lo planes)."""
    acc = torch.zeros(a_tiles.shape[1], b_tiles.shape[2])
    for a, b in zip(a_tiles, b_tiles):
        ah, al = split_tf32(a)
        bh, bl = split_tf32(b)
        if not skip_zero_lo or al.any():
            acc = acc + al @ bh
        if not skip_zero_lo or bl.any():
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def _values(kind, rng, shape):
    if kind == "integer":
        return rng.integers(-9, 10, shape).astype(np.float32)
    return _wide_gaussian(rng, shape)


# (A tile height, A tiles summed into one C/Y tile): the SpMM kernel at
# each tile height over a row's 3 slabs, the pair kernel's 64x128 C tile
# over 2 pairs
@pytest.mark.parametrize("tm,n_tiles", [(8, 3), (16, 3), (32, 3), (64, 3),
                                        (64, 2)])
@pytest.mark.parametrize("a_kind,b_kind", [("wide", "wide"),
                                           ("integer", "wide"),
                                           ("wide", "integer")])
def test_3xtf32_at_spmm_and_pair_shapes(tm, n_tiles, a_kind, b_kind):
    rng = np.random.default_rng(tm + n_tiles)
    a = _values(a_kind, rng, (n_tiles, tm, 128))
    b = _values(b_kind, rng, (n_tiles, 128, 128))
    exp = np.einsum("tik,tkj->ij", a.astype(np.float64), b.astype(np.float64))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = _accumulate_3xtf32(at, bt, skip_zero_lo=True)
    assert torch.equal(got, _accumulate_3xtf32(at, bt, skip_zero_lo=False))
    assert _within(got.numpy(), exp).all()
    tf32 = sum(rna_tf32(x) @ rna_tf32(y) for x, y in zip(at, bt))
    assert not _within(tf32.numpy(), exp).all()


@pytest.mark.parametrize("tm,n_tiles", [(8, 3), (16, 3), (64, 2)])
def test_integer_tiles_bit_equal_at_spmm_and_pair_shapes(tm, n_tiles):
    # integer A and X (the bench's value model): every lo is zero, only
    # the hi.hi products run, and the sum equals the plain f32 one exactly
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(1, 10, (n_tiles, tm, 128)).astype(
        np.float32))
    b = torch.from_numpy(rng.integers(-4, 5, (n_tiles, 128, 128)).astype(
        np.float32))
    got = _accumulate_3xtf32(a, b, skip_zero_lo=True)
    assert torch.equal(got, torch.bmm(a, b).sum(0))


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
