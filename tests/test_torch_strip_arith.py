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
kernel splits each X value once, in the registers of the thread that
feeds it to wgmma, for all the rows of its group, and skips the products
whose mid and lo operand is zero throughout a stage (those of A where its
present rows are TF32 values, those of X where the stage's X is); adding
those zero products changes no partial sum, so the skipped and the full
sums agree bit for bit, at the SpMM and pair shapes
(tests/test_torch_spmm_walk.py emulates the SpMM kernel's walk and
arithmetic whole, with its masked fold of absent rows). Where
every operand of a step is a TF32 value (integers below 2^11) the kernels
run one product on the raw bits, and the sum equals the plain f32 one
exactly. The emulation rounds to TF32 by bit masking (round to nearest,
ties away from zero, as cvt.rna does) and forms the products in f32 (each
TF32 x TF32 product is exact in f32); it does not reproduce the mma's
truncating alignment, which the card tests of long positive sums hold
(tests/test_torch_cuda.py).

Since the strip and pair kernels' pipeline runs on wgmma
(csrc/tile_pipeline.cuh), `emulate_walk` below emulates it whole: the
persistent CTAs' work items (C tile, 128-column chunk, row chunk) in each
CTA's order, the pairs of each item (the strip kernel's ordered scan of
its block's slot words, the pair kernel's pair_ptr range), the 32-deep
stages zero-filled past tk as the TMA maps fill them, the per-stage
TF32-exact flag (the OR of every staged A and B value's low bits), and
the transposed product C^T = B^T . A^T one k8 step at a time: one product
accumulated in place on a TF32-exact stage, else six split products into
a zeroed partial sum and one round-to-nearest add. Its tensor-core add is
exact and then rounded, to nearest or (`rz`, a model of the hardware's
truncating alignment) toward zero. tests/test_torch_kernels.py and
tests/test_torch_pair.py hold it against the plain versions and the
Pallas kernels in interpret mode.
"""

import os
import re

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


def test_serialised_wgmma_counts_each_ptxas_code():
    loss = ("ptxas info    : ({}) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to {}\n")
    log = (loss.format("C7515", "non wgmma instructions defining accumulator"
                                " registers")
           + loss.format("C7511", "the presence of Extern calls")
           + loss.format("C7513", "non wgmma instructions defining input "
                                  "registers")
           + "ptxas info    : (C7519) warpgroup.arrive is injected\n")
    assert kernels.serialised_wgmma(log) == 3
    assert kernels.serialised_wgmma("ptxas info    : Used 168 registers") == 0


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


# --- the wgmma pipeline's walk (csrc/tile_pipeline.cuh), emulated ---------

KC = 32          # k depth of a stage
COLS = 128       # C columns of an item


def _round_f32(x: torch.Tensor, mode: str) -> torch.Tensor:
    """f64 -> f32, to nearest ("rn") or toward zero ("rz")."""
    r = x.float()
    if mode == "rz":
        over = r.double().abs() > x.abs()
        r[over] = torch.nextafter(r[over], torch.zeros_like(r[over]))
    return r


def tensor_product(d, x, y, mode="rn"):
    """One tensor-core product d + x @ y (x, y TF32 values, d f32 or None
    for scale-d 0): the products and their sum exact (in f64), then one
    rounding to f32."""
    s = x.double() @ y.double()
    if d is not None:
        s = s + d.double()
    return _round_f32(s, mode)


def stage_takes_split(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The per-stage flag: whether any staged A or B value has one of the
    13 low bits TF32 drops set."""
    return bool(((a.contiguous().view(torch.int32) & 0x1FFF).any())
                or ((b.contiguous().view(torch.int32) & 0x1FFF).any()))


def emulate_chunk(stages, h, mode="rn", in_place=False):
    """One item's h x 128 chunk from its stages [(A h x 32, A_occ, B 32 x
    128, B_occ)], as the consumer warpgroups compute C^T = B^T . A^T;
    `in_place` adds the split products straight into the accumulator
    (the scheme that biased long positive sums). Returns (values,
    counts), h x 128 f32."""
    acc = torch.zeros(COLS, h)
    cnt = torch.zeros(COLS, h)
    for a, ao, b, bo in stages:
        at, bt = a.t(), b.t()            # (32, h), (128, 32)
        split = stage_takes_split(a, b)
        ah, am, al = split3_tf32(at.contiguous())
        bh, bm, bl = split3_tf32(bt.contiguous())
        for j in range(0, KC, 8):
            k = slice(j, j + 8)
            if not split:
                acc = tensor_product(acc, bt[:, k], at[k], mode)
                continue
            # (a part, b part): lo.hi, hi.lo, mid.mid, mid.hi, hi.mid,
            # hi.hi; B^T's part first in the product
            terms = ((bh, al), (bl, ah), (bm, am), (bh, am), (bm, ah),
                     (bh, ah))
            if in_place:
                for x, y in terms:
                    acc = tensor_product(acc, x[:, k], y[k], mode)
                continue
            part = None
            for x, y in terms:
                part = tensor_product(part, x[:, k], y[k], mode)
            acc = acc + part             # round to nearest
        cnt = tensor_product(cnt, bo.t().float(), ao.t().float())
    return acc.t(), cnt.t()


def _box(plane, g, r0, rows, k0, c0, cols, k_axis):
    """A TMA box of a (tiles, ., .) plane: `rows` x `cols` from (r0, c0)
    of tile g, k along `k_axis` (1: A's columns, 0: B's rows) from k0,
    zero past the tile's k extent."""
    t = plane[g].float()
    if k_axis == 1:
        out = torch.zeros(rows, KC)
        part = t[r0:r0 + rows, k0:k0 + KC]
    else:
        out = torch.zeros(KC, cols)
        part = t[k0:k0 + KC, c0:c0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def strip_pairs(ops, *, gm, max_b, max_cblock, block_rows):
    """The strip kernel's Walk: slot -> [(A tile, B slab, B column)] in
    ascending slot word order (csrc/strip_numeric.cu:StripWalk)."""
    _, _, b_val, _, aptr, ak, slots = ops
    tn = b_val.shape[2] // max_b
    aptr, ak, slots = aptr.tolist(), ak.tolist(), slots.tolist()

    def pairs(slot):
        blk, s = divmod(slot, max_cblock)
        r0 = blk * block_rows
        r1 = min(r0 + block_rows, gm)
        out = []
        for e in range(aptr[r0] * max_b, aptr[r1] * max_b):
            if slots[e] == s:
                g, y = divmod(e, max_b)
                out.append((g, ak[g], y * tn))
        return out
    return pairs


def pair_pairs(pa, pb, pair_ptr):
    """The pair kernel's Walk (csrc/pair_accumulate.cu:PairWalk)."""
    pa, pb, ptr = pa.tolist(), pb.tolist(), pair_ptr.tolist()
    return lambda seg: [(pa[j], pb[j], 0) for j in range(ptr[seg],
                                                          ptr[seg + 1])]


def emulate_walk(planes, n_tiles, tn, pairs_of, *, sms=5, mode="rn"):
    """The persistent launches of csrc/tile_pipeline.cuh on `planes` (A
    values/occupancy (tiles, tm, tk), B (tiles, tk, ldb)): per row part,
    each CTA's items in its order, each item's stages, each chunk written
    once. Returns (c_val, c_cnt, order) with order the (cta, tile, cc,
    row_off) of each item as run."""
    a_val, a_occ, b_val, b_occ = planes
    tm, tk = a_val.shape[1:]
    c_val = torch.full((n_tiles, tm, tn), float("nan"))
    c_cnt = torch.full((n_tiles, tm, tn), float("nan"))
    writes = torch.zeros(n_tiles, tm, tn, dtype=torch.int32)
    parts, n_cc = kernels.chunk_grid(tm, tn)
    order = []
    for h, row_base, n_rc in parts:
        for cta, items in enumerate(kernels.cta_items(n_tiles * n_cc * n_rc,
                                                      sms)):
            for item in items:
                tile, cc, rc = kernels.item_coords(item, n_cc, n_rc)
                r0, c0 = row_base + rc * h, cc * COLS
                order.append((cta, tile, cc, r0))
                stages = [
                    (_box(a_val, ga, r0, h, k0, 0, 0, 1),
                     _box(a_occ, ga, r0, h, k0, 0, 0, 1),
                     _box(b_val, gb, 0, 0, k0, bcol + c0, COLS, 0),
                     _box(b_occ, gb, 0, 0, k0, bcol + c0, COLS, 0))
                    for ga, gb, bcol in pairs_of(tile)
                    for k0 in range(0, tk, KC)]
                v, c = emulate_chunk(stages, h, mode)
                sl = (tile, slice(r0, r0 + h), slice(c0, c0 + COLS))
                c_val[sl], c_cnt[sl] = v, c
                writes[sl] += 1
    assert (writes == 1).all(), "every element is written exactly once"
    return c_val, c_cnt, order


@pytest.mark.parametrize("tm,tn,n_tiles,sms", [
    (64, 128, 7, 3), (40, 384, 2, 5), (8, 256, 9, 132), (128, 128, 1, 4)])
def test_work_items_cover_each_chunk_once_in_order(tm, tn, n_tiles, sms):
    """Each launch's items are (tile, cc, rc) in the CUDA numbering, each
    exactly once over its CTAs, CTA c taking c, c + grid, ... (grid = the
    SMs, or fewer items)."""
    parts, n_cc = kernels.chunk_grid(tm, tn)
    for h, row_base, n_rc in parts:
        n_items = n_tiles * n_cc * n_rc
        per_cta = kernels.cta_items(n_items, sms)
        assert len(per_cta) == min(n_items, sms)
        seen = sorted(i for items in per_cta for i in items)
        assert seen == list(range(n_items))
        for c, items in enumerate(per_cta):
            assert items == list(range(c, n_items, len(per_cta)))
        coords = [kernels.item_coords(i, n_cc, n_rc) for i in range(n_items)]
        assert coords == [(t, cc, rc) for t in range(n_tiles)
                          for cc in range(n_cc) for rc in range(n_rc)]
        for item, (t, cc, rc) in enumerate(coords):
            assert item == (t * n_cc + cc) * n_rc + rc
            assert row_base + rc * h + h <= tm


def test_chunk_constants_match_the_pipeline_source():
    """ops/kernels.py's mirrors hold the constants of
    csrc/tile_pipeline.cuh: the row-chunk heights, the column chunk, the
    chunk limit and the stage depth the emulation uses."""
    src = open(os.path.join(os.path.dirname(kernels.KERNEL_SRC),
                            "tile_pipeline.cuh")).read()
    heights = re.search(r"for_each_row_part<([\d, ]+)>", src).group(1)
    assert tuple(int(h) for h in heights.split(",")) == kernels.CHUNK_HEIGHTS

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kTN") == kernels.COL_CHUNK == COLS
    assert const("kMaxChunks") == kernels.MAX_CHUNKS
    assert const("kKC") == KC


def test_stage_flag_is_one_per_stage():
    """One value off the TF32 grid anywhere in a stage, in A or in either
    warpgroup's half of B, sends the whole stage through the split; the
    zero fill past tk never does."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(-9, 10, (16, KC)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-9, 10, (KC, COLS)).astype(np.float32))
    assert not stage_takes_split(a, b)
    for where in ("a_first", "a_last", "b_first", "b_last"):
        a2, b2 = a.clone(), b.clone()
        if where == "a_first":
            a2[0, 0] = 1.0 + 2.0 ** -20
        elif where == "a_last":
            a2[-1, -1] = 1.0 + 2.0 ** -20
        elif where == "b_first":
            b2[0, 0] = 1.0 + 2.0 ** -20
        else:
            b2[-1, -1] = 1.0 + 2.0 ** -20   # the second warpgroup's half
        assert stage_takes_split(a2, b2)
        got, _ = emulate_chunk([(a2, a2 != 0, b2, b2 != 0)], 16)
        exp = a2.double() @ b2.double()
        assert _within(got.numpy(), exp.numpy()).all()
    # exact stages give the plain f32 product bit for bit
    got, cnt = emulate_chunk([(a, a != 0, b, b != 0)], 16)
    assert torch.equal(got, a @ b)
    assert torch.equal(cnt, (a != 0).float() @ (b != 0).float())


@pytest.mark.parametrize("h", [8, 16, 32, 64])
def test_transposed_split_within_tolerance(h):
    """Wide-range values (1e-3..1e3) through the transposed split product,
    over four pairs of tk 128: within rtol 1e-5, atol 1e-6*max|C| of the
    f64 product, where TF32 alone is not."""
    rng = np.random.default_rng(h)
    a = torch.from_numpy(_wide_gaussian(rng, (4, h, 128)))
    b = torch.from_numpy(_wide_gaussian(rng, (4, 128, COLS)))
    stages = [(a[t][:, k:k + KC], a[t][:, k:k + KC] != 0, b[t][k:k + KC],
               b[t][k:k + KC] != 0)
              for t in range(4) for k in range(0, 128, KC)]
    got, _ = emulate_chunk(stages, h)
    exp = np.einsum("tik,tkj->ij", a.double().numpy(), b.double().numpy())
    assert _within(got.numpy(), exp).all()
    tf32 = sum(rna_tf32(x) @ rna_tf32(y) for x, y in zip(a, b))
    assert not _within(tf32.numpy(), exp).all()


@pytest.mark.parametrize("h", [8, 64])
def test_long_positive_sums_show_no_bias(h):
    """A long positive sum (k = 4096 at 30% density, ~1,230 products per
    element) with a truncating tensor-core add: the zeroed partial sums
    folded by round-to-nearest stay within rtol 1e-5 of the f64 product
    and show no downward bias, where the same products added in place
    drift low past it."""
    rng = np.random.default_rng(21)
    k = 4096
    a = (rng.random((h, k)) * (rng.random((h, k)) < 0.3)).astype(np.float32)
    b = (rng.random((k, COLS)) * (rng.random((k, COLS)) < 0.3)).astype(
        np.float32)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    stages = [(at[:, j:j + KC], at[:, j:j + KC] != 0, bt[j:j + KC],
               bt[j:j + KC] != 0) for j in range(0, k, KC)]
    exp = a.astype(np.float64) @ b.astype(np.float64)
    got, _ = emulate_chunk(stages, h, mode="rz")
    rel = (got.double().numpy() - exp) / exp
    assert np.abs(rel).max() <= RTOL
    assert abs(rel.mean()) < 0.1 * RTOL
    drift, _ = emulate_chunk(stages, h, mode="rz", in_place=True)
    rel_in_place = (drift.double().numpy() - exp) / exp
    assert rel_in_place.max() < 0 and np.abs(rel_in_place).max() > RTOL
