"""The tensor-core kernels' arithmetic, emulated in plain torch on the CPU.

All three value kernels (csrc/strip_numeric.cu, csrc/pair_accumulate.cu,
and the 128-column form of csrc/spmm_strip.cu) split each f32 operand
exactly into three TF32 values (hi = rna_tf32(x), mid = rna_tf32(x - hi),
lo = the rest) and, per k8 step, put the six partial products above
2^-33 |a.b| (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi) into a zeroed
partial sum that one round-to-nearest add folds into the accumulator:
every product is then exact to far below f32's rounding. The earlier
3xTF32 scheme (hi, lo = rna_tf32(x - hi), three products added in place)
carries up to about 2^-22 |a.b| per product, and in place the mma's
truncating alignment biased long positive sums downward; the first tests
below still hold its emulation to the kernels' card tolerance (rtol 1e-5,
atol 1e-6*max|C| of an f64 product, at tk = 128, on Gaussian values
spanning 1e-3..1e3) as the yardstick TF32 alone must miss. The SpMM
kernel splits each X chunk into hi/mid/lo planes once, for all warps, and
skips the products whose mid and lo operand is zero throughout (those of
A where its fragments are TF32 values, those of X where the chunk's X
is); adding those zero products changes no partial sum, so the skipped
and the full sums agree bit for bit, at the SpMM and pair shapes. Where
every operand of a step is a TF32 value (integers below 2^11) the kernels
run one product on the raw bits, and the sum equals the plain f32 one
exactly. The emulation rounds to TF32 by bit masking (round to nearest,
ties away from zero, as cvt.rna does) and forms the products in f32 (each
TF32 x TF32 product is exact in f32); it does not reproduce the mma's
truncating alignment, which the card tests of long positive sums hold
(tests/test_torch_cuda.py).
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


def _is_tf32(x: torch.Tensor) -> bool:
    return not (x.contiguous().view(torch.int32) & 0x1FFF).any()


def _accumulate_split(a_tiles, b_tiles, skip_zero_rest):
    """sum_t a_tiles[t] @ b_tiles[t] as the kernels take it: per k8 step,
    one raw product accumulated in place where every operand is a TF32
    value, else the six split products (smallest first) into a zeroed
    partial sum that is then added to the accumulator; with
    skip_zero_rest the terms whose mid/lo operand is zero throughout are
    left out (B split once per step, as the SpMM kernel's planes)."""
    acc = torch.zeros(a_tiles.shape[1], b_tiles.shape[2])
    for a_t, b_t in zip(a_tiles, b_tiles):
        for k0 in range(0, a_t.shape[1], 8):
            a, b = a_t[:, k0:k0 + 8], b_t[k0:k0 + 8]
            a_rest, b_rest = not _is_tf32(a), not _is_tf32(b)
            if not a_rest and not b_rest:
                acc = acc + a @ b
                continue
            ah, am, al = split3_tf32(a)
            bh, bm, bl = split3_tf32(b)
            terms = ((al, bh, a_rest), (ah, bl, b_rest),
                     (am, bm, a_rest and b_rest), (am, bh, a_rest),
                     (ah, bm, b_rest), (ah, bh, True))
            part = torch.zeros_like(acc)
            for x, y, live in terms:
                if live or not skip_zero_rest:
                    part = part + x @ y
            acc = acc + part
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
    """The pair and SpMM kernels' exact split (which replaced their
    3xTF32) at their shapes: skipping the zero terms is bit-equal to the
    full sum, and both meet the card tolerance that TF32 alone misses."""
    rng = np.random.default_rng(tm + n_tiles)
    a = _values(a_kind, rng, (n_tiles, tm, 128))
    b = _values(b_kind, rng, (n_tiles, 128, 128))
    exp = np.einsum("tik,tkj->ij", a.astype(np.float64), b.astype(np.float64))
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    got = _accumulate_split(at, bt, skip_zero_rest=True)
    assert torch.equal(got, _accumulate_split(at, bt, skip_zero_rest=False))
    assert _within(got.numpy(), exp).all()
    tf32 = sum(rna_tf32(x) @ rna_tf32(y) for x, y in zip(at, bt))
    assert not _within(tf32.numpy(), exp).all()


@pytest.mark.parametrize("tm,n_tiles", [(8, 3), (16, 3), (64, 2)])
def test_integer_tiles_bit_equal_at_spmm_and_pair_shapes(tm, n_tiles):
    # integer A and X (the bench's value model): every operand is a TF32
    # value, each k8 step is one raw product, and the sum equals the plain
    # f32 one exactly
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(1, 10, (n_tiles, tm, 128)).astype(
        np.float32))
    b = torch.from_numpy(rng.integers(-4, 5, (n_tiles, 128, 128)).astype(
        np.float32))
    got = _accumulate_split(a, b, skip_zero_rest=True)
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


def split3_tf32(x: torch.Tensor):
    """The strip kernel's exact split: x = hi + mid + lo, three TF32
    values."""
    hi = rna_tf32(x)
    mid = rna_tf32(x - hi)
    return hi, mid, (x - hi) - mid


def test_split3_is_exact_in_tf32_pieces():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(_wide_gaussian(rng, 100000))
    hi, mid, lo = split3_tf32(x)
    assert _is_tf32(hi) and _is_tf32(mid) and _is_tf32(lo)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())


def test_split3_products_are_exact_to_2_pow_minus_30():
    """The strip kernel's six partial products (lo.hi, hi.lo, mid.mid,
    mid.hi, hi.mid, hi.hi, each exact in f64) against the exact product:
    within 2^-30 relative, where 3xTF32 errs by more than f32's own
    rounding (2^-24)."""
    rng = np.random.default_rng(8)
    a = torch.from_numpy(_wide_gaussian(rng, 200000))
    b = torch.from_numpy(_wide_gaussian(rng, 200000))
    exact = a.double() * b.double()
    ah, am, al = (t.double() for t in split3_tf32(a))
    bh, bm, bl = (t.double() for t in split3_tf32(b))
    six = al * bh + ah * bl + am * bm + am * bh + ah * bm + ah * bh
    assert ((six - exact).abs() <= 2.0 ** -30 * exact.abs()).all()
    (ah2, al2), (bh2, bl2) = split_tf32(a), split_tf32(b)
    three = (al2.double() * bh2.double() + ah2.double() * bl2.double()
             + ah2.double() * bh2.double())
    assert ((three - exact).abs() > 2.0 ** -24 * exact.abs()).any()
