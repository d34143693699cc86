"""The 128-column SpMM kernel's item walk and arithmetic, emulated on the
CPU (`csrc/spmm_strip.cu:spmm_wgmma_kernel` runs only on the card).

The kernel's work items are (row group, 128-column chunk of k_pad): a
group is GROUP_ROWS = 64 Y rows, G = 64/h virtual rows of sub-tile
height h, numbered item = group * n_cc + cc. A lookup warp merges the
group's rows' ak lists into slab records: the next slab is the least next
ak over the rows, each row whose next tile sits on that slab takes it, and
an entry holds (slab, the mask of the rows present, each present row's
sub-tile index); a record holds up to REC_SLABS entries. Every X slab is
staged once per item for all the group's rows. The emulation here follows
that walk on the packed plan of `ops/spmm.py` and checks what the kernel
relies on: every (virtual row, tile) of the plan is visited exactly once
per column chunk, each row's tiles in ascending ak, groups may span block
edges and the last group may be short, and the window form's slab
kmin[blk] + (ak - kmin[blk]) is slab ak. Its Y, summed in the walk's
order, equals the plain version `spmm_strip_plain` (exactly on integer
values), which tests/test_torch_spmm.py holds against the JAX package's
Pallas kernels.

`emulate_spmm` then emulates the kernel's arithmetic on that walk: per
32-deep stage the group's A rows (a row absent from the entry's slab
holds NaN, standing for whatever an earlier stage left there), the X
stage zero-filled past tk, the two stage flags (A's present rows, X), and
Y^T = X^T . A^T one k8 step at a time: one product in place where both
flags are clear and every row is present, else the split products (those
with a zero part left out) into a zeroed partial folded by a
round-to-nearest add on the present rows only. It is bit-equal to the
plain version on integers and within rtol 1e-5 of the f64 product on
Gaussian values and on long positive sums (with the tensor core's adds
modelled as truncating), at every compiled height.
"""

import os
import re

import numpy as np
import pytest
import torch

import spgemm_tpu_torch as pt
import spgemm_tpu_torch.ops.spmm as pspmm
from spgemm_tpu_torch.ops import spmm_kernels
from test_torch_strip_arith import (_is_tf32, _wide_gaussian, split3_tf32,
                                    tensor_product)

GROUP_ROWS = 64    # Y rows of an item (kN)
REC_SLABS = 16     # slabs a record holds (kRecSlabs)
COLS = 128         # Y columns of an item (kCols)
KC = 32            # k depth of a stage (kKC)
RTOL, ATOL_REL = 1e-5, 1e-6
INT_MAX = 2 ** 31 - 1


def group_records(aptr, ak, group, *, G, q, gm_v, cap=REC_SLABS):
    """The records of one row group as the lookup warp publishes them:
    [[(slab, mask, {row: sub-tile})...]...], at least one (maybe empty)
    record, each of at most `cap` entries."""
    cur, end, sub = [0] * G, [0] * G, [0] * G
    for r in range(G):
        v = group * G + r
        if v < gm_v:
            i, sub[r] = divmod(v, q)
            cur[r], end[r] = int(aptr[i]), int(aptr[i + 1])
    records, entries = [], []
    while True:
        mine = [int(ak[c]) if c < e else INT_MAX for c, e in zip(cur, end)]
        s = min(mine)
        if s == INT_MAX:
            break
        if len(entries) == cap:
            records.append(entries)
            entries = []
        hit = [m == s for m in mine]
        mask = sum(1 << r for r in range(G) if hit[r])
        entries.append((s, mask, {r: cur[r] * q + sub[r]
                                  for r in range(G) if hit[r]}))
        cur = [c + h for c, h in zip(cur, hit)]
    records.append(entries)
    return records


def item_walk(aptr, ak, *, gm, n_rows, tm, n_cc, cap=REC_SLABS):
    """[(group, cc, records)] in the kernels' item order (group * n_cc +
    cc)."""
    h, q = spmm_kernels.sub_tiles(tm)
    G = GROUP_ROWS // h
    n_groups = -(-n_rows * q // G)
    out = []
    for item in range(n_groups * n_cc):
        group, cc = divmod(item, n_cc)
        out.append((group, cc, group_records(aptr, ak, group, G=G, q=q,
                                             gm_v=gm * q, cap=cap)))
    return out


def walk_y(ops, kmin, *, gm, block_rows, tm, cap=REC_SLABS):
    """Y by the walk, and the (virtual row, tile, cc) visits in order."""
    a_dense, xb, aptr, ak = (t.numpy() for t in ops[:4])
    k_pad = xb.shape[2]
    h, q = spmm_kernels.sub_tiles(tm)
    G = GROUP_ROWS // h
    n_rows = max(1, -(-gm // block_rows)) * block_rows
    sub = a_dense.reshape(-1, h, a_dense.shape[2])
    y = np.zeros((n_rows * q, h, k_pad), np.float32)
    visits = []
    for group, cc, records in item_walk(aptr, ak, gm=gm, n_rows=n_rows,
                                        tm=tm, n_cc=k_pad // COLS, cap=cap):
        cols = slice(cc * COLS, cc * COLS + COLS)
        for rec in records:
            assert len(rec) <= cap
            for slab, mask, subs in rec:
                assert mask == sum(1 << r for r in subs) and mask
                for r, s in subs.items():
                    v = group * G + r
                    g, j = divmod(s, q)
                    assert j == v % q and v < gm * q
                    if kmin is not None:  # the window form's rebased slab
                        klo = int(kmin[v // q // block_rows])
                        assert klo + (slab - klo) == slab
                    assert slab == int(ak[g])
                    visits.append((v, g, cc))
                    y[v][:, cols] += sub[s] @ xb[slab][:, cols]
    return y.reshape(n_rows, tm, k_pad), visits


def _matrix(kind, rng):
    if kind == "banded_gaps":
        # a band with empty row ranges: empty tile rows and whole groups
        r = np.repeat(np.arange(900), 21)
        c = r + np.tile(np.arange(-10, 11), 900)
        keep = (c >= 0) & (c < 900) & (rng.random(r.size) < 0.6)
        keep &= (r < 200) | (r >= 420)
        keep &= (r < 640) | (r >= 650)
        return pt.CSR.from_coo(r[keep], c[keep],
                               rng.integers(1, 10, keep.sum()).astype(
                                   np.float64), (900, 900))
    # ragged: rows of 0 to 39 scattered nonzeros, and every third run of
    # 64 rows empty (empty tile rows at every tile height)
    n = 700
    counts = rng.integers(0, 40, n) * (rng.random(n) < 0.8)
    counts[np.arange(n) // 64 % 3 == 1] = 0
    r = np.repeat(np.arange(n), counts)
    c = rng.integers(0, 1100, r.size)
    return pt.CSR.from_coo(r, c, rng.integers(1, 10, r.size).astype(
        np.float64), (n, 1100))


@pytest.mark.parametrize("kind", ["banded_gaps", "ragged"])
@pytest.mark.parametrize("tm", [8, 16, 32, 64])
@pytest.mark.parametrize("block_rows,cap", [(6, REC_SLABS), (8, 2)])
def test_walk_visits_every_tile_once_in_ascending_ak(kind, tm, block_rows,
                                                     cap):
    rng = np.random.default_rng(tm + block_rows)
    a = _matrix(kind, rng)
    t = pt.csr_to_tiles(a, tm, 16)
    x = rng.integers(-4, 5, (a.n, 130)).astype(np.float64)
    ops = pspmm._pack_spmm_operands(t, x, 256, torch.float32,
                                    block_rows).to_device("cpu")
    stats = pspmm._spmm_block_stats(t, block_rows)
    kmin = pspmm._window_kmin(t, stats)
    for km in (None, kmin):
        y, visits = walk_y(ops, km, gm=t.gm, block_rows=block_rows, tm=tm,
                           cap=cap)
        # every real (row, tile) once a column chunk; rows past gm and
        # padding tiles never
        exp = [(int(t.trow[g]), g, cc) for g in range(t.nt)
               for cc in range(2)]
        assert sorted(visits) == sorted(exp)
        assert len(set(visits)) == len(visits)
        for row in range(t.gm):
            mine = [g for r, g, cc in visits if r == row and cc == 0]
            cols = [int(t.tcol[g]) for g in mine]
            assert cols == sorted(cols) and mine == sorted(mine)
        plain = spmm_kernels.spmm_strip_plain(
            *ops, None if km is None else torch.from_numpy(km), gm=t.gm,
            block_rows=block_rows)
        np.testing.assert_array_equal(y, plain.numpy())
    # the shapes the kernel must handle show up here
    g_rows = GROUP_ROWS // tm
    n_rows = plain.shape[0]
    if block_rows % g_rows:
        assert any((g0 // block_rows) != ((g0 + g_rows - 1) // block_rows)
                   for g0 in range(0, n_rows, g_rows))  # a group spans blocks
    assert np.diff(t.tptr).min() == 0  # empty tile rows
    if n_rows % g_rows:
        assert n_rows // g_rows * g_rows < n_rows  # a short last group


@pytest.mark.parametrize("cap", [REC_SLABS, 1])
def test_walk_merges_slabs_shared_by_rows(cap):
    # two tile rows of one group (tm 32: G = 2) on the same slabs: each
    # slab is one entry, staged once, for both rows; records of one entry
    # give the same sequence
    aptr = np.array([0, 2, 4], np.int32)
    ak = np.array([3, 5, 3, 7], np.int32)
    (group, cc, records), = item_walk(aptr, ak, gm=2, n_rows=2, tm=32,
                                      n_cc=1, cap=cap)
    assert (group, cc) == (0, 0)
    assert all(len(rec) <= cap for rec in records)
    assert [e for rec in records for e in rec] == [
        (3, 0b11, {0: 0, 1: 2}), (5, 0b01, {0: 1}), (7, 0b10, {1: 3})]


def test_sub_tile_rows_share_one_group():
    # tm 128 is two sub-tiles of 64 (q = 2, G = 1): each virtual row is its
    # own group and reads sub-tile g*q + j of its tile row's tiles; tm 24
    # is three of 8 (G = 8: two tile rows' six, then two rows past gm, and
    # a second group of one row past gm with an empty record)
    aptr = np.array([0, 2, 3], np.int32)
    ak = np.array([1, 4, 2], np.int32)
    walk = item_walk(aptr, ak, gm=2, n_rows=2, tm=128, n_cc=1)
    assert [(g, [e for rec in r for e in rec]) for g, _, r in walk] == [
        (0, [(1, 1, {0: 0}), (4, 1, {0: 2})]),
        (1, [(1, 1, {0: 1}), (4, 1, {0: 3})]),
        (2, [(2, 1, {0: 4})]), (3, [(2, 1, {0: 5})])]
    (_, _, recs), (_, _, past) = item_walk(aptr, ak, gm=2, n_rows=3, tm=24,
                                           n_cc=1)
    assert past == [[]]
    assert [e for rec in recs for e in rec] == [
        (1, 0b000111, {0: 0, 1: 1, 2: 2}),
        (2, 0b111000, {3: 6, 4: 7, 5: 8}),
        (4, 0b000111, {0: 3, 1: 4, 2: 5})]


def test_walk_constants_match_the_source():
    """The emulation's constants are the kernel's: the group's rows (wgmma
    N), the slabs a record holds, the column chunk and the stage depth."""
    src = open(spmm_kernels.KERNEL_SRC).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kN") == GROUP_ROWS
    assert const("kRecSlabs") == REC_SLABS
    assert const("kCols") == COLS == spmm_kernels.KCOLS
    assert const("kKC") == KC
    assert os.path.basename(spmm_kernels.KERNEL_SRC) == "spmm_strip.cu"


# --- the arithmetic on the walk ------------------------------------------


def emulate_stage(acc, a_stage, rows, x_stage, mode="rn"):
    """One 32-deep stage into acc (COLS x GROUP_ROWS, Y^T): a_stage
    (GROUP_ROWS x KC) the group's A rows, `rows` which of them are present
    (the others NaN), x_stage (KC x COLS)."""
    a_rest = not _is_tf32(a_stage[rows])
    x_rest = not _is_tf32(x_stage)
    at, xt = a_stage.t().contiguous(), x_stage.t().contiguous()
    if not a_rest and not x_rest and bool(rows.all()):
        for j in range(0, KC, 8):
            acc = tensor_product(acc, xt[:, j:j + 8], at[j:j + 8], mode)
        return acc
    ah, am, al = split3_tf32(at)
    xh, xm, xl = split3_tf32(xt)
    # (A part, X part): lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi, those
    # with a zero part left out (X^T's part first in the product)
    terms = ((xh, al, a_rest), (xl, ah, x_rest), (xm, am, a_rest and x_rest),
             (xh, am, a_rest), (xm, ah, x_rest), (xh, ah, True))
    for j in range(0, KC, 8):
        part = None
        for x, a, live in terms:
            if live:
                part = tensor_product(part, x[:, j:j + 8], a[j:j + 8], mode)
        acc[:, rows] = acc[:, rows] + part[:, rows]   # round to nearest
    return acc


def emulate_spmm(ops, *, gm, block_rows, mode="rn"):
    """Y as the 128-column kernel computes it, item by item (the window
    form reads the same slabs)."""
    a_dense, xb, aptr, ak = ops[:4]
    _, tm, tk = a_dense.shape
    k_pad = xb.shape[2]
    h, q = spmm_kernels.sub_tiles(tm)
    G = GROUP_ROWS // h
    n_rows = max(1, -(-gm // block_rows)) * block_rows
    sub = a_dense.reshape(-1, h, tk)
    y = torch.full((n_rows * q * h, k_pad), float("nan"))
    for group, cc, records in item_walk(aptr.numpy(), ak.numpy(), gm=gm,
                                        n_rows=n_rows, tm=tm,
                                        n_cc=k_pad // COLS):
        acc = torch.zeros(COLS, GROUP_ROWS)
        for slab, mask, subs in (e for rec in records for e in rec):
            rows = torch.tensor([bool(mask >> (r // h) & 1)
                                 for r in range(GROUP_ROWS)])
            for k0 in range(0, tk, KC):
                kk = min(KC, tk - k0)
                a_stage = torch.full((GROUP_ROWS, KC), float("nan"))
                for r, s in subs.items():
                    a_stage[r * h:(r + 1) * h] = 0.0
                    a_stage[r * h:(r + 1) * h, :kk] = sub[s][:, k0:k0 + kk]
                x_stage = torch.zeros(KC, COLS)
                x_stage[:kk] = xb[slab][k0:k0 + kk, cc * COLS:(cc + 1) * COLS]
                acc = emulate_stage(acc, a_stage, rows, x_stage, mode)
        r0 = group * GROUP_ROWS
        r1 = min(r0 + GROUP_ROWS, y.shape[0])
        y[r0:r1, cc * COLS:(cc + 1) * COLS] = acc.t()[:r1 - r0]
    return y.reshape(n_rows, tm, k_pad)


def _spmm_ops(a, x, tm, tk, k_pad, block_rows):
    t = pt.csr_to_tiles(a, tm, tk)
    return t, pspmm._pack_spmm_operands(t, x, k_pad, torch.float32,
                                        block_rows).to_device("cpu")


def _band(rng, n, values):
    r = np.repeat(np.arange(n), 41)
    c = r + np.tile(np.arange(-20, 21), n)
    keep = (c >= 0) & (c < n) & (rng.random(r.size) < 0.5)
    keep &= (r < 40) | (r >= 90)   # empty tile rows: absent rows
    v = (rng.integers(1, 10, keep.sum()).astype(np.float64)
         if values != "wide" else _wide_gaussian(rng, keep.sum()))
    return pt.CSR.from_coo(r[keep], c[keep], v, (n, n))


@pytest.mark.parametrize("tm", [8, 16, 32, 64, 24])
@pytest.mark.parametrize("values", ["integer", "gaussian_x", "wide"])
def test_spmm_arithmetic_on_the_walk(tm, values):
    """Integer A and X bit-equal to the plain version; Gaussian X against
    integer A (three products a step) and wide-range values on both sides
    (six) within rtol 1e-5, atol 1e-6*max|Y| of the f64 product, with NaN
    in every absent row of every stage and the last group past gm."""
    rng = np.random.default_rng(tm)
    a = _band(rng, 200, values)
    x = (rng.integers(-4, 5, (a.n, 130)).astype(np.float64)
         if values == "integer" else _wide_gaussian(rng, (a.n, 130)))
    t, ops = _spmm_ops(a, x, tm, 40, 256, 3)
    got = emulate_spmm(ops, gm=t.gm, block_rows=3)
    plain = spmm_kernels.spmm_strip_plain(*ops, gm=t.gm, block_rows=3)
    assert not torch.isnan(got).any()
    if values == "integer":
        assert torch.equal(got, plain)
        return
    a_d, xb, _, ak, arow = (v.double() if v.is_floating_point() else v
                            for v in ops)
    exp = torch.zeros_like(plain, dtype=torch.float64)
    g = torch.arange(int(ops[2][t.gm]))
    exp.index_add_(0, arow[g].long(), torch.bmm(a_d[g], xb[ak[g].long()]))
    scale = exp.abs().max()
    assert ((got.double() - exp).abs()
            <= RTOL * exp.abs() + ATOL_REL * scale).all()


@pytest.mark.parametrize("tm", [8, 64])
def test_spmm_long_positive_sums_on_the_walk(tm):
    """Long rows of positive products (A 64 x 2048 at 30%, about 600
    products per Y entry) with the tensor core's adds truncating: the
    zeroed partials folded by round-to-nearest stay within rtol 1e-5 of
    the f64 product."""
    rng = np.random.default_rng(23)
    k = 2048
    d = rng.random((64, k)) * (rng.random((64, k)) < 0.3)
    a = pt.CSR.from_dense(d)
    x = rng.random((k, 128))
    t, ops = _spmm_ops(a, x, tm, 128, 128, 8)
    got = emulate_spmm(ops, gm=t.gm, block_rows=8, mode="rz")
    f32 = lambda v: v.astype(np.float32).astype(np.float64)
    exp = f32(d) @ f32(x)
    rel = (got.reshape(-1, 128)[:64].double().numpy() - exp) / exp
    assert np.abs(rel).max() <= RTOL
