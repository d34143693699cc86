"""Runtime tile shapes: the port's strip, pair, SpMM and Ozaki kernels
take every tile their TPU kernels take (tm % 8 == 0, tn a multiple of
128), and at those shapes the plain versions (what each CUDA kernel is
held against on the card) agree with the JAX kernels run in interpret
mode, from the identical plan.

Besides: the router's decision on CUDA against the reference's `aligned`
rule (spgemm_tpu/ops/spgemm.py:143), the kernels' launch geometry
(ops/kernels.py:chunk_grid and its SpMM and Ozaki counterparts, mirrors
of the CUDA sources), and a NumPy emulation of each kernel's chunked
addressing (the offsets csrc/strip_numeric.cu, pair_accumulate.cu,
spmm_strip.cu and ozaki_strip.cu compute from blockIdx) against the plain
version.

Tolerances: integer values are exact in f32 and must agree exactly;
Gaussian values are summed in another order, so rtol 1e-5 and atol
1e-6*max|C|. The Ozaki planes (h, m, l) are bit-equal (exact int32 group
sums, one TwoSum sequence). Counts are compared as > 0, as the pipeline
reads them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgemm_tpu.models.tile as jtile
import spgemm_tpu.ops.spmm as jspmm
from spgemm_tpu.ops import ozaki as jo
from spgemm_tpu.ops.gustavson import build_strip_args as j_build_strip_args
from spgemm_tpu.ops.pallas_kernels import (gustavson_strip_pallas,
                                           ozaki_strip_pallas,
                                           pair_accumulate_pallas,
                                           spmm_strip_pallas,
                                           spmm_window_pallas)
from spgemm_tpu.ops.symbolic import build_pair_schedule as j_schedule
from spgemm_tpu.utils.generators import banded as j_banded

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import gustavson as pg
from spgemm_tpu_torch.ops import kernels
from spgemm_tpu_torch.ops import ozaki as po
from spgemm_tpu_torch.ops import ozaki_kernels as ok
from spgemm_tpu_torch.ops import pair_kernels
from spgemm_tpu_torch.ops import spmm as pspmm
from spgemm_tpu_torch.ops import spmm_kernels
from spgemm_tpu_torch.ops.spgemm import _resolve_backend

CPU, CUDA = torch.device("cpu"), torch.device("cuda")
# (tm, tn) of the strip and pair cases: a height that is no power of two,
# two row chunks, two column chunks, and both at once
STRIP_TILES = [(24, 128), (128, 128), (8, 256), (40, 384)]
OZAKI_TILES = [(8, 128), (64, 128), (24, 256)]
SPMM_TM = [24, 128]


def _banded(n, band, values, seed):
    rng = np.random.default_rng(seed)
    a = j_banded(rng, n, band)
    if values == "gaussian":
        return a.with_data(rng.standard_normal(a.nnz))
    return a


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def _assert_close(got, exp, values):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if values == "integer":
        np.testing.assert_array_equal(got, exp)
    else:
        scale = float(np.abs(exp).max()) if exp.size else 0.0
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6 * scale)


def _strip_plan(tm, tn, values, window, seed=5):
    """The JAX strip plan and the port's copy of it (StripArgs.from_numpy)."""
    a = _banded(max(260, tn + 60), 40, values, seed)
    jp = j_build_strip_args(jtile.csr_to_tiles(a, tm, tn),
                            jtile.csr_to_tiles(a, tn, tn), block_rows=8,
                            window=window)
    pp = pg.StripArgs.from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    return jp, pp


# --- the launch geometry (mirrors of the CUDA sources) ------------------

def _cover(parts, cols, col_chunk, tm, tn):
    """How often each C element is written by the chunks of a launch
    plan: exactly once where the plan tiles the C tile."""
    cover = np.zeros((tm, tn), np.int64)
    for h, row0, n in parts:
        for c in range(n):
            r = row0 + c * h
            for z in range(cols):
                cover[r:r + h, z * col_chunk:(z + 1) * col_chunk] += 1
    return cover


@pytest.mark.parametrize("tm,tn,grid", [
    (8, 128, ([(8, 0, 1)], 1)), (16, 128, ([(16, 0, 1)], 1)),
    (64, 128, ([(64, 0, 1)], 1)), (24, 128, ([(16, 0, 1), (8, 16, 1)], 1)),
    (40, 384, ([(32, 0, 1), (8, 32, 1)], 3)),
    (48, 256, ([(32, 0, 1), (16, 32, 1)], 2)),
    (128, 128, ([(64, 0, 2)], 1)),
    (120, 128, ([(64, 0, 1), (32, 64, 1), (16, 96, 1), (8, 112, 1)], 1)),
    (8, 256, ([(8, 0, 1)], 2)),
    (12, 128, None), (16, 64, None), (16, 200, None), (0, 128, None),
    (64 * 65536, 128, None), (8, 128 * 65536, None)])
def test_strip_and_pair_chunk_grid(tm, tn, grid):
    assert kernels.chunk_grid(tm, tn) == grid
    assert pair_kernels.pair_kernel_takes(tm, tn) == (grid is not None)
    assert kernels.strip_kernel_takes(tm, tn, tn) == (grid is not None)
    if grid is not None:
        parts, cols = grid
        assert all(h in (64, 32, 16, 8) for h, _, _ in parts)
        assert (_cover(parts, cols, 128, tm, tn) == 1).all()


@pytest.mark.parametrize("tm,sub", [
    (8, (8, 1)), (16, (16, 1)), (32, (32, 1)), (64, (64, 1)),
    (24, (8, 3)), (40, (8, 5)), (48, (16, 3)), (128, (64, 2)),
    (12, None), (4, None)])
def test_spmm_sub_tiles(tm, sub):
    assert spmm_kernels.sub_tiles(tm) == sub
    assert spmm_kernels.spmm_kernel_takes(tm) == (sub is not None)


@pytest.mark.parametrize("tm,tn,grid", [
    (16, 128, (1, [(16, 0, 1)])), (32, 128, (1, [(32, 0, 1)])),
    (8, 128, (1, [(8, 0, 1)])), (64, 128, (1, [(32, 0, 2)])),
    (24, 256, (2, [(16, 0, 1), (8, 16, 1)])),
    (128, 384, (3, [(32, 0, 4)])), (56, 128, (1, [(32, 0, 1), (16, 32, 1),
                                                  (8, 48, 1)])),
    (12, 128, None), (32, 64, None)])
def test_ozaki_grid(tm, tn, grid):
    # items of 128 columns (two consumer warpgroups of 64) and row chunks
    # of 32, 16 and 8 rows; with all 15 pair groups 16 and 8
    assert ok.ozaki_grid(tm, tn) == grid
    assert ok.ozaki_kernel_takes(tm, 128, tn) == (grid is not None)
    if grid is not None:
        assert not ok.ozaki_kernel_takes(tm, 120, tn)   # tk % 16
        cols, parts = grid
        assert (_cover(parts, cols, 128, tm, tn) == 1).all()
        wcols, wparts = ok.ozaki_grid(tm, tn, wide=True)
        assert wcols == cols and all(h <= 16 for h, _, _ in wparts)
        assert (_cover(wparts, wcols, 128, tm, tn) == 1).all()


# --- the router and the gates on CUDA ------------------------------------

def _reference_aligned(tm, tk, tn):
    """spgemm_tpu/ops/spgemm.py:143 on hardware."""
    return tn % 128 == 0 and tm % 8 == 0 and tk % 128 == 0


@pytest.mark.parametrize("tm", [8, 12, 16, 24, 40, 64, 128])
@pytest.mark.parametrize("tn", [16, 64, 128, 256])
def test_router_matches_reference_aligned_rule(tm, tn):
    """On CUDA the tiled router takes the strip kernel exactly where the
    reference's aligned rule holds (its tk is A's tile width, tn here);
    the other shapes go on to the reference's fallbacks, as before."""
    from spgemm_tpu_torch.utils.generators import cantlike

    a = cantlike(300, 16)
    at, bt = pt.csr_to_tiles(a, tm, tn), pt.csr_to_tiles(a, tn, tn)
    route, note = _resolve_backend(at, bt, "auto", torch.float32, CUDA)
    if _reference_aligned(tm, tn, tn):
        assert (route, note) == ("strip", "")
    else:
        assert route in ("dense", "gustavson", "xla")
    # backend="strip" names the fallback where the kernel cannot run
    route, note = _resolve_backend(at, bt, "strip", torch.float32, CUDA)
    assert (route == "strip") == _reference_aligned(tm, tn, tn)
    assert (note == "") == _reference_aligned(tm, tn, tn)
    # check_strip_feasible (the executors' gate) agrees
    sargs = pg.build_strip_args(at, bt)
    if _reference_aligned(tm, tn, tn):
        pg.check_strip_feasible(sargs, CUDA)
    else:
        with pytest.raises(ValueError, match="strip kernel takes"):
            pg.check_strip_feasible(sargs, CUDA)
    # the Ozaki route's gate and the SpMM mode
    assert po.strip_kernel_takes(tm, tn, tn, CUDA) == \
        _reference_aligned(tm, tn, tn)
    mode = pspmm._spmm_mode(at, 128, device=CUDA)[0]
    assert (mode != "xla") == (tm % 8 == 0)


@pytest.mark.parametrize("tm,tn", [(12, 128), (16, 64)])
def test_pair_backend_rejects_unaligned_tiles_on_cuda(tm, tn):
    """backend="pallas" raises on CUDA for tiles the pair kernel does not
    take, before any plan is built or uploaded."""
    from spgemm_tpu_torch.ops.spgemm import _spgemm_pairs
    from spgemm_tpu_torch.utils.generators import cantlike

    a = cantlike(200, 8)
    at, bt = pt.csr_to_tiles(a, tm, tn), pt.csr_to_tiles(a, tn, tn)
    with pytest.raises(NotImplementedError, match="tm % 8 == 0"):
        _spgemm_pairs(at, bt, backend="pallas", f64=False, device=CUDA)


# --- the strip kernel's plain version against the Pallas kernels ---------

@pytest.mark.parametrize("tm,tn", STRIP_TILES)
@pytest.mark.parametrize("window", [None, False])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_strip_matches_pallas(tm, tn, window, values):
    jp, pp = _strip_plan(tm, tn, values, window)
    assert (jp.tm, jp.tn) == (tm, tn)
    jv, jc = gustavson_strip_pallas(*map(jnp.asarray, jp.device_args()),
                                    **jp.kernel_kwargs(), interpret=True)
    before = kernels.strip_numeric.plain_launches
    pv, pc = kernels.strip_numeric(*pp.to_device("cpu"), **pp.kernel_kwargs())
    assert kernels.strip_numeric.plain_launches == before + 1
    g = pp.gather_idx
    assert pv.shape == jv.shape and g.size > 0
    _assert_close(pv.numpy()[g], np.asarray(jv)[g], values)
    np.testing.assert_array_equal(pc.numpy()[g] > 0,
                                  np.asarray(jc, np.float32)[g] > 0)


def _emulate_strip(ops, *, gm, max_b, max_cblock, block_rows):
    """csrc/strip_numeric.cu's addressing in NumPy: one "CTA" per (slot,
    row chunk c, column chunk z), each scanning its block's slot words and
    reading A, B and C through the flat offsets the kernel computes."""
    a_val, _, b_val, _, aptr, ak, slots = (
        None if t.dtype == torch.bfloat16 else t.numpy() for t in ops)
    ntp, tm, tk = a_val.shape
    tn = b_val.shape[2] // max_b
    parts, cols = kernels.chunk_grid(tm, tn)
    chunks = [(h, row0 + c * h) for h, row0, n in parts for c in range(n)]
    n_slots = -(-gm // block_rows) * max_cblock
    av, bv = a_val.ravel(), b_val.ravel()
    cv = np.zeros(n_slots * tm * tn, np.float64)
    ldb, a_tile = max_b * tn, tm * tk
    r_k, r_n = np.arange(tk)[None, :], np.arange(128)[None, :]
    for slot in range(n_slots):
        blk, s = divmod(slot, max_cblock)
        r0 = blk * block_rows
        r1 = min(r0 + block_rows, gm)
        for e in range(aptr[r0] * max_b, aptr[r1] * max_b):
            if slots[e] != s:
                continue
            g, y = divmod(e, max_b)
            for h, row_off in chunks:
                r_h = np.arange(h)[:, None]
                for z in range(cols):
                    col_off = z * 128
                    a_idx = row_off * tk + g * a_tile + r_h * tk + r_k
                    b_idx = (col_off + (ak[g] * tk + np.arange(tk)[:, None])
                             * ldb + y * tn + r_n)
                    c_idx = (slot * tm * tn + row_off * tn + col_off
                             + r_h * tn + r_n)
                    cv[c_idx] += av[a_idx].astype(np.float64) @ bv[b_idx]
    return cv.reshape(n_slots, tm, tn)


@pytest.mark.parametrize("tm,tn", [(40, 256), (120, 128)])
def test_strip_chunk_addressing_emulation(tm, tn):
    """The strip kernel's chunk offsets, emulated, give the plain C."""
    _, pp = _strip_plan(tm, tn, "integer", None, seed=9)
    ops = pp.to_device("cpu")
    pv, _ = kernels.strip_numeric_plain(*ops, **pp.kernel_kwargs())
    got = _emulate_strip(ops, **pp.kernel_kwargs())
    np.testing.assert_array_equal(got, pv.numpy())


# --- the pair kernel ------------------------------------------------------

def _pair_case(tm, tn, values, seed=2):
    a = _banded(max(260, tn + 60), 40, values, seed)
    jt = (jtile.csr_to_tiles(a, tm, tn), jtile.csr_to_tiles(a, tn, tn))
    sched = j_schedule(*jt)
    planes = (jt[0].dense(np.float32), jt[0].occ().astype(np.float32),
              jt[1].dense(np.float32), jt[1].occ().astype(np.float32))
    return planes, (sched.pa, sched.pb, sched.pair_ptr), sched.nt_c


@pytest.mark.parametrize("tm,tn", STRIP_TILES)
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_pair_matches_pallas(tm, tn, values):
    planes, idx, nt_c = _pair_case(tm, tn, values)
    assert planes[0].shape[1:] == (tm, tn) and nt_c > 0
    jv, jc = pair_accumulate_pallas(*map(jnp.asarray, planes + idx),
                                    num_segments=nt_c, interpret=True)
    w = pair_kernels.pair_accumulate_cuda
    before = (w.kernel_launches, w.plain_launches)
    pv, pc = w(*map(torch.from_numpy, planes + idx), num_segments=nt_c)
    assert (w.kernel_launches, w.plain_launches) == (before[0],
                                                     before[1] + 1)
    _assert_close(pv.numpy(), jv, values)
    np.testing.assert_array_equal(pc.numpy() > 0, np.asarray(jc) > 0)


def test_pair_chunk_addressing_emulation():
    """csrc/pair_accumulate.cu's chunk offsets (A tile pa*tm*lda + r*lda,
    B tile pb*tk*tn + z*128 at row stride tn, C seg*tm*tn + r*tn + z*128,
    r the chunk's first row), emulated, give the plain C; lda pads tk to a
    multiple of 8."""
    tm, tn = 40, 256
    planes, (pa, pb, ptr), nt_c = _pair_case(tm, tn, "integer", seed=4)
    a_val, _, b_val, _ = planes
    tk = a_val.shape[2]
    lda = -(-tk // 8) * 8
    av = np.pad(a_val, ((0, 0), (0, 0), (0, lda - tk))).ravel()
    bv = b_val.ravel()
    parts, cols = kernels.chunk_grid(tm, tn)
    chunks = [(h, row0 + c * h) for h, row0, n in parts for c in range(n)]
    cv = np.zeros(nt_c * tm * tn, np.float64)
    r_n = np.arange(128)[None, :]
    for seg in range(nt_c):
        for j in range(ptr[seg], ptr[seg + 1]):
            for h, r in chunks:
                r_h = np.arange(h)[:, None]
                for z in range(cols):
                    a_idx = (pa[j] * tm * lda + r * lda + r_h * lda
                             + np.arange(tk)[None, :])
                    b_idx = (pb[j] * tk * tn + z * 128
                             + np.arange(tk)[:, None] * tn + r_n)
                    c_idx = seg * tm * tn + r * tn + z * 128 + r_h * tn \
                        + r_n
                    cv[c_idx] += av[a_idx].astype(np.float64) @ bv[b_idx]
    pv, _ = pair_kernels.pair_accumulate_plain(
        *map(torch.from_numpy, planes + (pa, pb, ptr)), num_segments=nt_c)
    np.testing.assert_array_equal(cv.reshape(nt_c, tm, tn), pv.numpy())


# --- the Ozaki kernel -----------------------------------------------------

def _ozaki_plan(tm, tn, values, seed=3, band=20):
    a = _banded(max(260, tn + 60), band, values, seed)
    ja, jb = jtile.csr_to_tiles(a, tm, tn), jtile.csr_to_tiles(a, tn, tn)
    jp = jo.build_ozaki_strip(ja, jb, block_rows=8)
    pp = po.OzakiStripPlan.from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})
    return jp, pp


@pytest.mark.parametrize("tm,tn", OZAKI_TILES)
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_ozaki_matches_pallas(tm, tn, values):
    jp, pp = _ozaki_plan(tm, tn, values)
    assert (jp.sa, jp.sb) == ((1, 1) if values == "integer" else (8, 8))
    s = jp.sargs
    exp = ozaki_strip_pallas(
        *map(jnp.asarray, (jp.av8, s.a_occ, jp.bv8, s.b_occ, s.aptr,
                           s.kmin, s.meta)), interpret=True,
        **jp.kernel_kwargs())
    exp = [np.asarray(x, np.float32) for x in exp]
    before = ok.ozaki_strip_numeric.plain_launches
    got = [x.numpy() for x in ok.ozaki_strip_numeric(
        *pp.to_device("cpu"), **pp.kernel_kwargs())]
    assert ok.ozaki_strip_numeric.plain_launches == before + 1
    g = s.gather_idx
    assert g.size > 0
    for x, y in zip(got[:3], exp[:3]):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x[g], y[g])
    np.testing.assert_array_equal(got[3][g] > 0, exp[3][g] > 0)


def test_ozaki_chunk_addressing_emulation():
    """csrc/ozaki_strip.cu's chunk offsets (A slice s of the row chunk from
    row r at av8 rows s*tm + r, B slice t at columns (t*max_b + y)*tn +
    z*128) give
    the plain version's exact int32 group sums, through the same
    triple-float reduce: h, m, l bit-equal."""
    tm, tn = 24, 256
    jp, pp = _ozaki_plan(tm, tn, "gaussian", seed=8, band=6)
    ops = [None if t.dtype == torch.bfloat16 else t.numpy()
           for t in pp.to_device("cpu")]
    av8, _, bv8, _, aptr, ak, slots = ops
    kw = pp.kernel_kwargs()
    gm, max_b, max_cblock, block_rows = (kw["gm"], kw["max_b"],
                                         kw["max_cblock"], kw["block_rows"])
    sa, sb, pmax = kw["sa"], kw["sb"], kw["pmax"]
    n_groups = min(sa + sb - 1, pmax + 1)
    stack_rows, tk = av8.shape[1:]
    cols, parts = ok.ozaki_grid(tm, tn)
    chunks = [(h, row0 + c * h) for h, row0, n in parts for c in range(n)]
    n_slots = -(-gm // block_rows) * max_cblock
    a8, b8 = av8.ravel().astype(np.int64), bv8.ravel().astype(np.int64)
    ldb = sb * max_b * tn
    acc = np.zeros((n_slots, n_groups, tm, tn), np.int64)
    r_k = np.arange(tk)
    for slot in range(n_slots):
        blk, s_c = divmod(slot, max_cblock)
        r0 = blk * block_rows
        r1 = min(r0 + block_rows, gm)
        for e in range(aptr[r0] * max_b, aptr[r1] * max_b):
            if slots[e] != s_c:
                continue
            g, y = divmod(e, max_b)
            for h, r in chunks:
                r_h = np.arange(h)[:, None]
                for z in range(cols):
                    for s in range(sa):
                        a_idx = (g * stack_rows + r) * tk + \
                            (s * tm + r_h) * tk + r_k[None, :]
                        for t in range(sb):
                            if s + t > pmax:
                                continue
                            b_idx = ((ak[g] * tk + r_k[:, None]) * ldb
                                     + y * tn + z * 128 + t * max_b * tn
                                     + np.arange(128)[None, :])
                            acc[slot, s + t, r:r + h,
                                z * 128:(z + 1) * 128] += a8[a_idx] @ b8[b_idx]
    assert np.abs(acc).max() < 2 ** 31
    hh, mm, ll = ok.triple_float_reduce(torch.from_numpy(
        acc.astype(np.int32)))
    got = ok.ozaki_strip_numeric_plain(*pp.to_device("cpu"), **kw)
    for x, y in zip((hh, mm, ll), got[:3]):
        assert torch.equal(x, y)


# --- the SpMM kernel ------------------------------------------------------

def _spmm_case(tm, k, values, seed=6):
    rng = np.random.default_rng(seed)
    a = j_banded(rng, 700, 30)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
        x = rng.standard_normal((a.n, k))
    else:
        x = rng.integers(-4, 5, (a.n, k)).astype(np.float64)
    return a, x, jtile.csr_to_tiles(a, tm, 128)


@pytest.mark.parametrize("tm", SPMM_TM)
@pytest.mark.parametrize("k", [1, 128, 256])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_spmm_matches_pallas(tm, k, values):
    """k 1 packs X at the narrow width 8 (SpMV), 128 runs the resident and
    256 the window form; the reference runs at the 128-padded k."""
    block_rows = 2
    a, x, jt = _spmm_case(tm, k, values)
    k_pad = max(128, -(-k // 128) * 128)
    width = spmm_kernels.pack_width(k)
    stats = jspmm._spmm_block_stats(jt, block_rows)
    j_ops = jspmm._pack_spmm_operands(jt, x, k_pad, jnp.float32, block_rows)
    kw = dict(gm=jt.gm, max_ablock=j_ops[5], block_rows=block_rows,
              interpret=True)
    p_t = pt.csr_to_tiles(to_port(a), tm, 128)
    p_ops = pspmm._pack_spmm_operands(p_t, x, width, torch.float32,
                                      block_rows)
    kmin = None
    if k == 256:
        kmin_np = np.clip(stats[1], 0, jt.gn - stats[2]).astype(np.int32)
        exp = spmm_window_pallas(*map(jnp.asarray, j_ops[:5]),
                                 jnp.asarray(kmin_np), kwin=stats[2], **kw)
        kmin = torch.from_numpy(kmin_np)
    else:
        exp = spmm_strip_pallas(*map(jnp.asarray, j_ops[:5]), **kw)
    w = spmm_kernels.spmm_strip
    before = w.plain_launches
    got = w(*p_ops.to_device("cpu"), kmin, gm=jt.gm, block_rows=block_rows)
    assert w.plain_launches == before + 1
    assert got.shape[1:] == (tm, width)
    _assert_close(got.numpy()[..., :k], np.asarray(exp)[..., :k], values)
    y = got.numpy().reshape(-1, width)[: a.m, :k]
    np.testing.assert_allclose(y, a.to_dense() @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("tm,k", [(24, 128), (128, 8), (40, 16)])
def test_spmm_sub_tile_addressing_emulation(tm, k):
    """csrc/spmm_strip.cu's virtual rows: row v = i*q + j reads sub-tile
    g*q + j of each tile g of tile row i (the flat (h, tk) block at
    a + (g*q + j)*h*tk) and writes Y rows v*h .. v*h+h."""
    block_rows = 2
    a, x, _ = _spmm_case(tm, k, "integer", seed=11)
    p_t = pt.csr_to_tiles(to_port(a), tm, 128)
    p_ops = pspmm._pack_spmm_operands(p_t, x, spmm_kernels.pack_width(k),
                                      torch.float32, block_rows)
    a_dense, xb, aptr, ak, arow = p_ops.to_device("cpu")
    want = spmm_kernels.spmm_strip_plain(a_dense, xb, aptr, ak, arow,
                                         gm=p_t.gm, block_rows=block_rows)
    h, q = spmm_kernels.sub_tiles(tm)
    tk, width = a_dense.shape[2], xb.shape[2]
    sub = a_dense.numpy().reshape(-1, h, tk)     # the no-copy re-view
    xs = xb.numpy()
    y = np.zeros((want.shape[0] * q, h, width))
    for v in range(p_t.gm * q):
        i, j = divmod(v, q)
        for g in range(aptr[i], aptr[i + 1]):
            y[v] += sub[g * q + j].astype(np.float64) @ xs[ak[g]]
    np.testing.assert_array_equal(y.reshape(want.shape), want.numpy())
