"""The port's structured f64 route (ops/ozaki.py, ops/ozaki_kernels.py)
against the JAX package's Ozaki strip route on the CPU: the same value
model and plan array for array, the plain kernel version against the
Pallas kernel in interpret mode, and the f64 routing of spgemm_csr.

Tolerances: none. Both versions form exact int32 group sums and reduce
them with the same f32 TwoSum sequence (the scales 2^(-7p) are powers of
two, so a contracted multiply-add could not change a bit either), so h,
m and l must be array-equal, and C's values equal to JAX's. Counts are
compared only as > 0, as the pipeline reads them (the JAX kernel keeps
them in bf16 products).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spgemm_tpu
import spgemm_tpu.models.tile as jtile
from spgemm_tpu.ops import ozaki as jo
from spgemm_tpu.ops.pallas_kernels import ozaki_strip_pallas
from spgemm_tpu.utils.generators import banded as j_banded

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import ozaki as po
from spgemm_tpu_torch.ops import ozaki_kernels as ok
from spgemm_tpu_torch.utils import native as pnative

STRIP_FIELDS = ("aptr", "ak", "slots", "gather_idx", "ctrow", "ctcol",
                "nt_c", "num_pairs", "gm", "gn_c", "tm", "tk", "tn",
                "max_b", "max_ablock", "max_cblock", "block_rows", "kwin")


def _values(kind: str, n: int, rng) -> np.ndarray:
    if kind == "integer":
        return rng.integers(1, 10, n).astype(np.float64)
    if kind == "gaussian":
        return rng.standard_normal(n)
    if kind == "wide-int":       # 21-bit integers: S = 3
        return rng.integers(-2 ** 20, 2 ** 20, n).astype(np.float64)
    if kind == "wild":           # per-row scales across the f64 range
        return rng.standard_normal(n) * np.exp2(
            rng.integers(-300, 300, n).astype(np.float64))
    if kind == "wide-span":      # tests/test_ozaki.py:208: > 120-bit span
        return rng.standard_normal(n) * np.where(rng.random(n) < 0.5,
                                                 1e15, 1e-15)
    raise ValueError(kind)


def _pair(kind_a: str, kind_b: str, n: int = 300, band: int = 20,
          seed: int = 3):
    """(A, B) JAX CSRs on one banded pattern, values of the given kinds."""
    rng = np.random.default_rng(seed)
    a = j_banded(rng, n, band)
    return (a.with_data(_values(kind_a, a.nnz, rng)),
            a.with_data(_values(kind_b, a.nnz, rng)))


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def _tiles(a, b, tm):
    jt = (jtile.csr_to_tiles(a, tm, 128), jtile.csr_to_tiles(b, 128, 128))
    pa, pb = to_port(a), to_port(b)
    return jt, (pt.csr_to_tiles(pa, tm, 128), pt.csr_to_tiles(pb, 128, 128))


def _assert_plans_equal(got, exp):
    for f in ("av8", "bv8", "ea", "eb"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f), f)
    assert (got.sa, got.sb, got.pmax) == (exp.sa, exp.sb, exp.pmax)
    for f in STRIP_FIELDS:
        np.testing.assert_array_equal(getattr(got.sargs, f),
                                      getattr(exp.sargs, f), f)
    for f in ("a_occ", "b_occ"):
        g, e = getattr(got.sargs, f), getattr(exp.sargs, f)
        np.testing.assert_array_equal(g.view(np.uint16), e.view(np.uint16), f)


def _port_plan(jp):
    return po.OzakiStripPlan.from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


@pytest.mark.parametrize("kinds", [("integer", "integer"),
                                   ("gaussian", "gaussian"),
                                   ("gaussian", "wide-int"),
                                   ("wild", "wild"),
                                   ("wide-span", "wide-span")])
@pytest.mark.parametrize("strict", [False, True])
def test_value_model_native_equals_numpy_and_jax(kinds, strict):
    a, b = _pair(*kinds)
    (ja, jb), (pa, pb) = _tiles(a, b, 16)
    outcomes = []
    for fn, args in ((po._scales_spans_native, (pa, pb)),
                     (po._scales_and_slices_prep, (pa, pb)),
                     (jo._scales_spans_native, (ja, jb))):
        try:
            r = fn(*args, strict=strict)
        except po.OzakiOverflow:
            outcomes.append("overflow")
            continue
        except jo.OzakiOverflow:
            outcomes.append("overflow")
            continue
        ea, eb, sa, sb, span = r if len(r) == 5 else r[2:]
        outcomes.append((ea.tolist(), eb.tolist(), sa, sb, span))
    assert outcomes[0] == outcomes[1] == outcomes[2]
    if not strict or kinds[0] != "wide-span":
        assert outcomes[0] != "overflow"


@pytest.mark.parametrize("kinds", [("integer", "integer"),
                                   ("gaussian", "gaussian"),
                                   ("gaussian", "wide-int"),
                                   ("wild", "wild")])
@pytest.mark.parametrize("tm", [16, 32])
def test_native_and_numpy_plans_equal(monkeypatch, kinds, tm):
    a, b = _pair(*kinds)
    _, (pa, pb) = _tiles(a, b, tm)
    native = po.build_ozaki_strip(pa, pb)
    monkeypatch.setattr(pnative, "get_lib", lambda: None)
    assert po._scales_spans_native(pa, pb) is None
    fallback = po.build_ozaki_strip(pa, pb)
    _assert_plans_equal(fallback, native)


@pytest.mark.parametrize("kinds", [("integer", "integer"),
                                   ("gaussian", "gaussian"),
                                   ("gaussian", "wide-int")])
@pytest.mark.parametrize("tm,block_rows", [(16, 8), (32, 4), (32, 32)])
def test_plan_matches_jax(kinds, tm, block_rows):
    a, b = _pair(*kinds, n=520, band=48)
    (ja, jb), (pa, pb) = _tiles(a, b, tm)
    jp = jo.build_ozaki_strip(ja, jb, block_rows=block_rows)
    pp = po.build_ozaki_strip(pa, pb, block_rows=block_rows)
    assert pp.sargs.kwin is not None and pp.sargs.block_rows == block_rows
    _assert_plans_equal(pp, jp)
    # the JAX plan carried across is the port's plan
    _assert_plans_equal(_port_plan(jp), pp)
    assert pp.stack_rows == max(32, pp.sa * tm)


@pytest.mark.parametrize("tm,kinds,pmax,sizes", [
    (16, ("integer", "integer"), None, (1, 1)),
    (32, ("integer", "integer"), None, (1, 1)),
    (32, ("gaussian", "gaussian"), None, (8, 8)),
    (32, ("gaussian", "gaussian"), 14, (8, 8)),
    (16, ("gaussian", "wide-int"), 2, (8, 3)),
    (16, ("gaussian", "wide-int"), None, (8, 3)),
    (16, ("gaussian", "wide-int"), 9, (8, 3)),
])
def test_plain_matches_pallas(tm, kinds, pmax, sizes):
    a, b = _pair(*kinds, n=260, band=20)
    (ja, jb), _ = _tiles(a, b, tm)
    jp = jo.build_ozaki_strip(ja, jb, block_rows=8)
    assert (jp.sa, jp.sb) == sizes
    jkw = jp.kernel_kwargs()
    pp = _port_plan(jp)
    pkw = pp.kernel_kwargs()
    if pmax is not None:
        jkw["pmax"] = pkw["pmax"] = pmax
    s = jp.sargs
    exp = ozaki_strip_pallas(
        *map(jnp.asarray, (jp.av8, s.a_occ, jp.bv8, s.b_occ, s.aptr,
                           s.kmin, s.meta)), interpret=True, **jkw)
    exp = [np.asarray(x, np.float32) for x in exp]
    before = ok.ozaki_strip_numeric.plain_launches
    got = [x.numpy() for x in ok.ozaki_strip_numeric(*pp.to_device("cpu"),
                                                     **pkw)]
    assert ok.ozaki_strip_numeric.plain_launches == before + 1
    g = s.gather_idx
    for x, y in zip(got[:3], exp[:3]):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x[g], y[g])
    np.testing.assert_array_equal(got[3][g] > 0, exp[3][g] > 0)
    unused = np.ones(got[0].shape[0], bool)
    unused[g] = False
    assert not any(x[unused].any() for x in got)


def test_triple_float_reduce_carries_53_bits():
    # 2^53 - 1 split over two groups: the (h, m, l) triple holds it exactly
    groups = torch.tensor([[[[2 ** 29 - 1]], [[2 ** 29 - 1]]]],
                          dtype=torch.int32)
    h, m, l = ok.triple_float_reduce(groups)
    total = h.double() + m.double() + l.double()
    assert total.item() == (2 ** 29 - 1) * (1 + 2.0 ** -7)


def _scipy(a):
    return sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)


@pytest.mark.parametrize("tm", [16, 32])
@pytest.mark.parametrize("aat", [False, True])
def test_spgemm_csr_f64_matches_jax(tm, aat):
    a, _ = _pair("gaussian", "gaussian", n=420, band=24)
    jc, jres = spgemm_tpu.spgemm_csr(a, tm=tm, aat=aat,
                                     compute_dtype=np.float64)
    pc, pres = pt.spgemm_csr(to_port(a), tm=tm, aat=aat,
                             compute_dtype=torch.float64, device="cpu")
    assert jres.stats["backend"] == pres.stats["backend"] \
        == "ozaki-strip(S=8x8)"
    assert pc.pattern_equal(jc)
    np.testing.assert_array_equal(pc.data, jc.data)
    for k in ("num_pairs", "numblkC_candidate", "numblkC", "nnzC", "nnzCub",
              "slices"):
        assert pres.stats[k] == jres.stats[k], k
    for k in ("symbolic_ms", "prep_ms", "upload_ms", "numeric_ms",
              "compact_ms"):
        assert pres.timings_ms[k] >= 0.0, k
    ref = _scipy(a) @ (_scipy(a).T if aat else _scipy(a))
    got = _scipy(pc)
    assert abs(got - ref).max() <= 1e-12 * abs(ref).max()


def _full_band(kind: str, n: int = 300, half: int = 3, seed: int = 12):
    """tests/test_ozaki.py's matrices: every offset of the band, values
    drawn after the pattern from one generator."""
    from spgemm_tpu.models.csr import CSR as JCSR

    rng = np.random.default_rng(seed)
    offs = np.arange(-half, half + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    return JCSR.from_coo(r, c, _values(kind, r.size, rng), (n, n))


@pytest.mark.parametrize("kind,expect", [("integer", "(f64-exact-int)"),
                                         ("wide-span", "esc"),
                                         ("wild", "ozaki-strip(S=8x8)")])
def test_f64_routing_matches_jax(kind, expect):
    a = _full_band(kind)
    jc, jres = spgemm_tpu.spgemm_csr(a, compute_dtype=np.float64)
    pc, pres = pt.spgemm_csr(to_port(a), compute_dtype=torch.float64,
                             device="cpu")
    assert expect in pres.stats["backend"]
    assert pres.stats["backend"] == jres.stats["backend"]
    assert pc.pattern_equal(jc)
    ref = _scipy(a) @ _scipy(a)
    assert abs(_scipy(pc) - ref).max() <= 1e-12 * abs(ref).max()


def test_int32_bound_failure_routes_to_esc(monkeypatch):
    monkeypatch.setattr(jo, "_INT32_HEADROOM", 2 ** 40)
    monkeypatch.setattr(po, "_INT32_HEADROOM", 2 ** 40)
    a, _ = _pair("integer", "integer", n=400, band=3, seed=6)
    a = a.with_data(a.data + 0.5)   # dodge the f32-exact-integer route
    (ja, jb), (pa, pb) = _tiles(a, a, 16)
    with pytest.raises(po.OzakiOverflow):
        po.build_ozaki_strip(pa, pb)
    with pytest.raises(po.OzakiOverflow):   # propagates, as in JAX
        pt.spgemm(pa, pb, backend="ozaki", device="cpu")
    _, jres = spgemm_tpu.spgemm_csr(a, compute_dtype=np.float64)
    pc, pres = pt.spgemm_csr(to_port(a), compute_dtype=torch.float64,
                             device="cpu")
    assert pres.stats["backend"] == jres.stats["backend"] == "esc"
    ref = _scipy(a) @ _scipy(a)
    assert abs(_scipy(pc) - ref).max() <= 1e-12 * abs(ref).max()


@pytest.mark.parametrize("kind", ["integer", "wide-span", "gaussian"])
def test_backend_ozaki_matches_jax(kind):
    """Explicit backend="ozaki" (non-strict): the integer model at S = 1
    equals scipy exactly, and every kind equals JAX's C."""
    a, _ = _pair(kind, kind, n=500, band=8, seed=4)
    (ja, jb), (pa, pb) = _tiles(a, a, 32)
    jres = spgemm_tpu.spgemm(ja, jb, backend="ozaki")
    before = ok.ozaki_strip_numeric.plain_launches
    pres = pt.spgemm(pa, pb, backend="ozaki", device="cpu")
    assert ok.ozaki_strip_numeric.plain_launches == before + 1
    assert pres.stats["backend"] == jres.stats["backend"]
    assert pres.stats["backend"].startswith("ozaki-strip")
    pc, jc = pres.c.to_csr(), jres.c.to_csr()
    assert pc.pattern_equal(jc)
    np.testing.assert_array_equal(pc.data, jc.data)
    if kind == "integer":
        assert (pres.schedule.sa, pres.schedule.sb) == (1, 1)
        ref = (_scipy(a) @ _scipy(a)).tocsr()
        assert abs(_scipy(pc) - ref).max() == 0.0


def test_spgemm_csr_backend_ozaki_matches_jax():
    a, _ = _pair("gaussian", "gaussian", n=200, band=6, seed=8)
    pc, pres = pt.spgemm_csr(to_port(a), backend="ozaki", device="cpu")
    jc, jres = spgemm_tpu.spgemm_csr(a, backend="ozaki")
    assert pres.stats["backend"] == jres.stats["backend"]
    assert pc.pattern_equal(jc)
    np.testing.assert_array_equal(pc.data, jc.data)


def test_empty_product_and_single_entry():
    empty = pt.CSR.from_coo([], [], np.zeros(0), (200, 200))
    res = pt.spgemm(pt.csr_to_tiles(empty, 16, 128),
                    pt.csr_to_tiles(empty, 128, 128), backend="ozaki",
                    device="cpu")
    assert res.c.nnz == 0 and res.stats["numblkC"] == 0
    one = pt.CSR.from_coo(np.array([0]), np.array([0]), np.array([3.0]),
                          (200, 200))
    res = pt.spgemm(pt.csr_to_tiles(one, 16, 128),
                    pt.csr_to_tiles(one, 128, 128), backend="ozaki",
                    device="cpu")
    c = res.c.to_csr()
    assert c.nnz == 1 and c.data[0] == 9.0


def test_53bit_results_exact():
    """The triple-float combine carries full f64 significands: 1e30 (a
    53-bit value) reconstructs bit for bit."""
    rng = np.random.default_rng(9)
    n = 200
    rr = np.zeros(100, np.int64)
    cc = np.arange(100)
    vv = np.concatenate([[1e30], rng.standard_normal(99)])
    a = pt.CSR.from_coo(rr, cc, vv, (n, n))
    b = pt.CSR.from_coo(cc, cc, np.ones(100), (n, n))
    res = pt.spgemm_ozaki(pt.csr_to_tiles(a, 16, 128),
                          pt.csr_to_tiles(b, 128, 128), device="cpu")
    assert res.c.to_csr().data[0] == 1e30


def test_arrow_pattern_raises_naming_the_slab_engine():
    """The windowed geometry is infeasible on an arrow pattern: both
    packages fall back to the slab engine (it no longer raises) and give
    the same C, through backend="ozaki" and the auto f64 router."""
    n = 4096
    r = np.concatenate([np.zeros(n // 8, np.int64),
                        np.arange(n, dtype=np.int64)])
    c = np.concatenate([np.arange(0, n, 8, dtype=np.int64),
                        np.arange(n, dtype=np.int64)])
    vals = ((r + c) % 7 + 1).astype(np.float64) + 0.5
    ja = spgemm_tpu.CSR.from_coo(r, c, vals, (n, n))
    a = pt.CSR.from_coo(r, c, vals, (n, n))
    at, bt = pt.csr_to_tiles(a, 32, 128), pt.csr_to_tiles(a, 128, 128)
    with pytest.raises(ValueError, match="windowed strip plan infeasible"):
        po.build_ozaki_strip(at, bt)
    res = pt.spgemm(at, bt, backend="ozaki", device="cpu")
    jres = spgemm_tpu.spgemm(jtile.csr_to_tiles(ja, 32, 128),
                             jtile.csr_to_tiles(ja, 128, 128),
                             backend="ozaki")
    assert res.stats["backend"] == jres.stats["backend"] \
        == "ozaki(S=1x1)(xla-fallback)"
    got, exp = res.c.to_csr(), jres.c.to_csr()
    assert got.pattern_equal(exp) and np.array_equal(got.data, exp.data)
    c64, res = pt.spgemm_csr(a, tm=32, compute_dtype=torch.float64,
                             device="cpu")
    # (r + c) % 7 + 1.5 is not an integer: no f32-exact shortcut
    assert res.stats["backend"] == "ozaki(S=1x1)(xla-fallback)"
    assert c64.pattern_equal(exp) and np.array_equal(c64.data, exp.data)


def test_cuda_tile_gate_and_bad_operands():
    # the strip kernel's tiles on CUDA; elsewhere the slab engine runs
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert po.strip_kernel_takes(32, 128, 128, cuda)
    assert not po.strip_kernel_takes(64, 128, 128, cuda)
    assert not po.strip_kernel_takes(16, 16, 16, cuda)
    assert not po.strip_kernel_takes(16, 40, 128, cuda)   # tk % 16
    assert po.strip_kernel_takes(64, 128, 128, cpu)
    assert po.strip_kernel_takes(16, 16, 16, cpu)
    a, b = _pair("gaussian", "gaussian", n=100, band=4)
    _, (pa, pb) = _tiles(a, b, 16)
    plan = po.build_ozaki_strip(pa, pb)
    ops = list(plan.to_device("cpu"))
    kw = plan.kernel_kwargs()
    bad = list(ops)
    bad[0] = bad[0].to(torch.int16)
    with pytest.raises(ValueError, match="av8"):
        ok.ozaki_strip_numeric(*bad, **kw)
    with pytest.raises(ValueError, match="inconsistent"):
        ok.ozaki_strip_numeric(*ops, **dict(kw, gm=kw["gm"] + 1))
    with pytest.raises(ValueError, match="sa, sb"):
        ok.ozaki_strip_numeric(*ops, **dict(kw, sa=9))
    with pytest.raises(ValueError, match="do not chain"):
        po.build_ozaki_strip(pa, pt.csr_to_tiles(to_port(b), 64, 128))


def test_non_finite_values_raise():
    a, _ = _pair("gaussian", "gaussian", n=100, band=4)
    bad = to_port(a)
    bad.data[3] = np.inf
    with pytest.raises(ValueError, match="finite"):
        po.build_ozaki_strip(pt.csr_to_tiles(bad, 16, 128),
                             pt.csr_to_tiles(bad, 128, 128))
