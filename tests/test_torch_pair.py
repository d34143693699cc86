"""The port's pair backends against the JAX package on the CPU: the
tile-pair schedule and pad_pairs equal array for array, the plain version
of the pair kernel against `pair_accumulate_pallas` in interpret mode, the
XLA pair accumulation against JAX's, and spgemm / spgemm_csr with
backend "pallas" and "xla" against the JAX entry points.

Tolerances: integer values are exact in f32 and must agree exactly;
Gaussian values are summed in another order, so rtol 1e-5 and atol
1e-6*max|C| in f32, rtol 1e-12 in f64. Counts are compared as > 0 only,
as the pipeline reads them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgemm_tpu
import spgemm_tpu.models.tile as jtile
from spgemm_tpu.models.csr import CSR as JCSR
from spgemm_tpu.ops import numeric as jnum
from spgemm_tpu.ops.pallas_kernels import pair_accumulate_pallas
from spgemm_tpu.ops.symbolic import build_pair_schedule as j_schedule
from spgemm_tpu.ops.symbolic import grid_symbolic_nnz as j_grid_nnz

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import numeric as pnum
from spgemm_tpu_torch.ops import pair_kernels
from spgemm_tpu_torch.ops.symbolic import (PairSchedule, build_pair_schedule,
                                           grid_symbolic_nnz)

SCHEDULE_FIELDS = ("pa", "pb", "seg", "pair_ptr", "ctrow", "ctcol", "c_tptr")


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def _operands(kind: str, rng):
    """(A, B) as JAX CSRs."""
    if kind == "square":
        a = JCSR.from_coo(rng.integers(0, 150, 1200), rng.integers(0, 150, 1200),
                          rng.integers(1, 10, 1200).astype(np.float64),
                          (150, 150))
        return a, a
    if kind == "rectangular":
        a = JCSR.from_coo(rng.integers(0, 130, 700), rng.integers(0, 90, 700),
                          rng.integers(1, 10, 700).astype(np.float64),
                          (130, 90))
        b = JCSR.from_coo(rng.integers(0, 90, 800), rng.integers(0, 170, 800),
                          rng.integers(1, 10, 800).astype(np.float64),
                          (90, 170))
        return a, b
    if kind == "empty_rows":
        # A's tile rows 1-3 are empty at tm 8 and 16
        r = rng.integers(0, 160, 900)
        r = r[(r < 16) | (r >= 64)]
        a = JCSR.from_coo(r, rng.integers(0, 160, r.size),
                          rng.integers(1, 10, r.size).astype(np.float64),
                          (160, 160))
        return a, a
    e = JCSR.from_coo([], [], np.zeros(0), (64, 64))
    return e, e


def _tiles(a, b, tm, tn):
    jt = (jtile.csr_to_tiles(a, tm, tn), jtile.csr_to_tiles(b, tn, tn))
    pt_ = (pt.csr_to_tiles(to_port(a), tm, tn),
           pt.csr_to_tiles(to_port(b), tn, tn))
    return jt, pt_


@pytest.mark.parametrize("kind", ["square", "rectangular", "empty_rows",
                                  "empty"])
@pytest.mark.parametrize("tm,tn", [(8, 16), (16, 16)])
def test_pair_schedule_matches_jax(kind, tm, tn):
    a, b = _operands(kind, np.random.default_rng(1))
    (ja, jb), (pa_, pb_) = _tiles(a, b, tm, tn)
    js, ps = j_schedule(ja, jb), build_pair_schedule(pa_, pb_)
    for name in SCHEDULE_FIELDS:
        got, exp = getattr(ps, name), getattr(js, name)
        assert got.dtype == exp.dtype, name
        np.testing.assert_array_equal(got, exp, err_msg=name)
    assert ps.c_grid_shape == js.c_grid_shape
    assert (ps.num_pairs, ps.nt_c) == (js.num_pairs, js.nt_c)
    assert grid_symbolic_nnz(pa_, pb_) == j_grid_nnz(ja, jb)
    if kind != "empty":
        assert ps.num_pairs > ps.nt_c > 0


def test_pair_schedule_rejects_mismatch():
    a, b = _operands("rectangular", np.random.default_rng(1))
    pa_ = pt.csr_to_tiles(to_port(a), 8, 16)
    with pytest.raises(ValueError, match="dimension mismatch"):
        build_pair_schedule(pa_, pa_)
    with pytest.raises(ValueError, match="inner tile dims"):
        build_pair_schedule(pa_, pt.csr_to_tiles(to_port(b), 8, 16))


@pytest.mark.parametrize("p,chunk", [(0, 4), (3, 4), (8, 4), (9, 4),
                                     (21, 8)])
def test_pad_pairs_matches_jax(p, chunk):
    rng = np.random.default_rng(p)
    pa = rng.integers(0, 50, p).astype(np.int32)
    pb = rng.integers(0, 50, p).astype(np.int32)
    seg = np.sort(rng.integers(0, 9, p)).astype(np.int32)
    for got, exp in zip(pnum.pad_pairs(pa, pb, seg, 9, chunk),
                        jnum.pad_pairs(pa, pb, seg, 9, chunk)):
        assert got.dtype == exp.dtype
        np.testing.assert_array_equal(got, exp)


def _planes(jt, np_dt):
    ja, jb = jt
    return (ja.dense(np_dt), ja.occ().astype(np.float32), jb.dense(np_dt),
            jb.occ().astype(np.float32))


def _assert_close(got, exp, values):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if values == "integer":
        np.testing.assert_array_equal(got, exp)
    else:
        scale = float(np.abs(exp).max()) if exp.size else 0.0
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("tm,tn", [(8, 16), (16, 16)])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_pair_matches_pallas(tm, tn, values):
    rng = np.random.default_rng(2)
    a, b = _operands("rectangular", rng)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
        b = b.with_data(rng.standard_normal(b.nnz))
    jt, _ = _tiles(a, b, tm, tn)
    sched = j_schedule(*jt)
    planes = _planes(jt, np.float32)
    idx = (sched.pa, sched.pb, sched.pair_ptr)
    jv, jc = pair_accumulate_pallas(*map(jnp.asarray, planes + idx),
                                    num_segments=sched.nt_c, interpret=True)
    w = pair_kernels.pair_accumulate_cuda
    before = (w.kernel_launches, w.plain_launches)
    pv, pc = w(*map(torch.from_numpy, planes + idx), num_segments=sched.nt_c)
    assert (w.kernel_launches, w.plain_launches) == (before[0],
                                                     before[1] + 1)
    assert pv.dtype == pc.dtype == torch.float32
    _assert_close(pv.numpy(), jv, values)
    np.testing.assert_array_equal(pc.numpy() > 0, np.asarray(jc) > 0)


@pytest.mark.parametrize("tm,tn", [(8, 16), (16, 16)])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_pair_bf16_occupancy_matches_pallas(tm, tn, values):
    """bf16 0/1 occupancy (what the pair backend uploads and the kernel
    reads) gives the JAX kernel's C and exactly the f32-occupancy result:
    the plain version counts in f32 either way."""
    rng = np.random.default_rng(12)
    a, b = _operands("rectangular", rng)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
        b = b.with_data(rng.standard_normal(b.nnz))
    jt, _ = _tiles(a, b, tm, tn)
    sched = j_schedule(*jt)
    planes = _planes(jt, np.float32)
    idx = (sched.pa, sched.pb, sched.pair_ptr)
    jv, jc = pair_accumulate_pallas(*map(jnp.asarray, planes + idx),
                                    num_segments=sched.nt_c, interpret=True)
    f32 = list(map(torch.from_numpy, planes + idx))
    bf16 = list(f32)
    bf16[1], bf16[3] = f32[1].to(torch.bfloat16), f32[3].to(torch.bfloat16)
    w = pair_kernels.pair_accumulate_cuda
    pv, pc = w(*bf16, num_segments=sched.nt_c)
    fv, fc = w(*f32, num_segments=sched.nt_c)
    assert pv.dtype == pc.dtype == torch.float32
    assert torch.equal(pv, fv) and torch.equal(pc, fc)
    _assert_close(pv.numpy(), jv, values)
    np.testing.assert_array_equal(pc.numpy() > 0, np.asarray(jc) > 0)
    pv2, pc2 = pair_kernels.pair_accumulate_plain(*bf16,
                                                  num_segments=sched.nt_c)
    assert torch.equal(pv2, pv) and torch.equal(pc2, pc)


@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_spgemm_pallas_uploads_bf16_occupancy(monkeypatch, values):
    """spgemm(backend="pallas") hands the pair kernel's wrapper bf16
    occupancy planes and still gives the JAX package's C."""
    rng = np.random.default_rng(13)
    a, b = _operands("rectangular", rng)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
        b = b.with_data(rng.standard_normal(b.nnz))
    (ja, jb), (pa_, pb_) = _tiles(a, b, 16, 16)
    seen = []
    real = pair_kernels._check_operands

    def spy(*args, **kw):  # the wrapper checks its operands first
        seen.append((args[1].dtype, args[3].dtype))
        return real(*args, **kw)

    monkeypatch.setattr(pair_kernels, "_check_operands", spy)
    res = pt.spgemm(pa_, pb_, backend="pallas", device="cpu")
    assert seen == [(torch.bfloat16, torch.bfloat16)]
    jres = spgemm_tpu.spgemm(ja, jb, backend="pallas")
    _assert_same_csr(res.c.to_csr(), jres.c.to_csr(), values)
    assert res.stats["nnzC"] == jres.stats["nnzC"]


def test_plain_pair_empty_tile_is_zero():
    """A C tile with no pairs (an empty range of pair_ptr) comes out
    zero."""
    rng = np.random.default_rng(3)
    a_val = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(
        np.float32))
    b_val = torch.from_numpy(rng.standard_normal((2, 16, 16)).astype(
        np.float32))
    a_occ, b_occ = (a_val != 0).float(), (b_val != 0).float()
    pa = torch.tensor([0, 2, 1], dtype=torch.int32)
    pb = torch.tensor([1, 0, 1], dtype=torch.int32)
    pair_ptr = torch.tensor([0, 2, 2, 3], dtype=torch.int32)
    cv, cc = pair_kernels.pair_accumulate_cuda(a_val, a_occ, b_val, b_occ, pa,
                                               pb, pair_ptr, num_segments=3)
    assert not cv[1].any() and not cc[1].any()
    torch.testing.assert_close(cv[0], a_val[0] @ b_val[1] + a_val[2] @ b_val[0])
    torch.testing.assert_close(cv[2], a_val[1] @ b_val[1])


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("chunk", [16, 32768])
def test_xla_pair_accumulate_matches_jax(dtype, chunk):
    rng = np.random.default_rng(4)
    a, b = _operands("square", rng)
    a = a.with_data(rng.standard_normal(a.nnz))
    jt, _ = _tiles(a, a, 16, 16)
    sched = j_schedule(*jt)
    np_dt = np.float64 if dtype == "f64" else np.float32
    planes = _planes(jt, np_dt)
    pa, pb, seg = jnum.pad_pairs(sched.pa, sched.pb, sched.seg, sched.nt_c,
                                 chunk)
    assert chunk > 16 or sched.num_pairs > 2 * chunk  # the loop runs
    jv, jc = jnum.pair_accumulate(
        *map(jnp.asarray, planes + (pa, pb, seg)), num_segments=sched.nt_c,
        chunk=chunk, acc_dtype=jnp.float64 if dtype == "f64" else jnp.float32)
    pv, pc = pnum.pair_accumulate(*map(torch.from_numpy, planes + (pa, pb, seg)),
                                  num_segments=sched.nt_c, chunk=chunk)
    assert pv.numpy().dtype == np_dt and pc.dtype == torch.float32
    if dtype == "f64":
        np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-12,
                                   atol=1e-12)
    else:
        _assert_close(pv.numpy(), jv, "gaussian")
    np.testing.assert_array_equal(pc.numpy() > 0, np.asarray(jc) > 0)


def _assert_same_csr(got, exp, values):
    assert got.pattern_equal(exp)
    if values == "integer":
        np.testing.assert_array_equal(got.data, exp.data)
    elif values == "f64":
        np.testing.assert_allclose(got.data, exp.data, rtol=1e-12)
    else:
        scale = float(np.abs(exp.data).max())
        np.testing.assert_allclose(got.data, exp.data, rtol=1e-5,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("kind", ["square", "rectangular"])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_spgemm_csr_pair_backends_match_jax(backend, kind, values):
    rng = np.random.default_rng(5)
    a, b = _operands(kind, rng)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
        b = b.with_data(rng.standard_normal(b.nnz))
    jb = None if kind == "square" else b
    jc, jres = spgemm_tpu.spgemm_csr(a, jb, backend=backend)
    w = pair_kernels.pair_accumulate_cuda
    before = w.plain_launches
    pc, pres = pt.spgemm_csr(to_port(a), None if jb is None else to_port(jb),
                             backend=backend, device="cpu")
    assert w.plain_launches == before + (backend == "pallas")
    assert pres.stats["backend"] == backend
    _assert_same_csr(pc, jc, values)
    for k in ("num_pairs", "numblkC_candidate", "numblkC", "nnzC", "nnzCub"):
        assert pres.stats[k] == jres.stats[k], k
    assert set(pres.timings_ms) == set(jres.timings_ms)
    assert isinstance(pres.schedule, PairSchedule)


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_pair_backends_empty_segments(backend):
    # C tiles whose pair list produces no products come out zero
    a = to_port(JCSR.from_coo([0], [0], [1.0], (4, 4)))
    b = to_port(JCSR.from_coo([1], [1], [1.0], (4, 4)))
    res = pt.spgemm(pt.csr_to_tiles(a, 2, 2), pt.csr_to_tiles(b, 2, 2),
                    backend=backend, device="cpu")
    assert res.c.nt == 0 and res.stats["numblkC_candidate"] == 1


def test_xla_f64_matches_jax():
    rng = np.random.default_rng(6)
    a, _ = _operands("square", rng)
    a = a.with_data(rng.standard_normal(a.nnz))
    jc, _ = spgemm_tpu.spgemm_csr(a, backend="xla",
                                  compute_dtype=jnp.float64)
    pc, pres = pt.spgemm_csr(to_port(a), backend="xla",
                             compute_dtype=torch.float64, device="cpu")
    assert pres.stats["backend"] == "xla"
    _assert_same_csr(pc, jc, "f64")
    ref = a.to_dense() @ a.to_dense()
    np.testing.assert_allclose(pc.data, ref[pc.rows_expanded(), pc.indices],
                               rtol=1e-12)


def test_pallas_rejects_f64(make_random_csr):
    a = make_random_csr(32, 32, 0.1)
    with pytest.raises(ValueError, match="float64"):
        spgemm_tpu.spgemm_csr(a, backend="pallas", compute_dtype=jnp.float64)
    with pytest.raises(ValueError, match="float64"):
        pt.spgemm_csr(to_port(a), backend="pallas",
                      compute_dtype=torch.float64, device="cpu")
    t = pt.csr_to_tiles(to_port(a), 8, 16)
    v = torch.from_numpy(t.dense(np.float64))
    none = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="float64"):
        pair_kernels.pair_accumulate_cuda(v, v, v, v, none, none,
                                          torch.zeros(1, dtype=torch.int32),
                                          num_segments=0)


def test_pair_wrapper_rejects_bad_operands():
    rng = np.random.default_rng(7)
    a, _ = _operands("square", rng)
    jt, _ = _tiles(a, a, 8, 16)
    sched = j_schedule(*jt)
    ops = list(map(torch.from_numpy, _planes(jt, np.float32)
                   + (sched.pa, sched.pb, sched.pair_ptr)))
    with pytest.raises(ValueError, match="inconsistent"):
        pair_kernels.pair_accumulate_cuda(*ops, num_segments=sched.nt_c + 1)
    ops[4] = ops[4].long()
    with pytest.raises(ValueError, match="pa"):
        pair_kernels.pair_accumulate_cuda(*ops, num_segments=sched.nt_c)
