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
from spgemm_tpu_torch.utils.generators import banded as p_banded

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


def entry_err(c, a, b) -> float:
    """max |C - A@B| / (|A||B|)_ij over C's entries, against scipy's f64
    product (whose own error is a few units of 2^-53 of the same sum)."""
    sa, sb = _scipy(a), _scipy(b)
    mag = (abs(sa) @ abs(sb)).tocsr()
    err = abs(_scipy(c) - sa @ sb).tocsr()
    return float(err.multiply(mag.power(-1)).max()) if mag.nnz else 0.0


@pytest.mark.parametrize("tm", [16, 32])
@pytest.mark.parametrize("aat", [False, True])
def test_spgemm_csr_f64_matches_jax(tm, aat):
    """The auto f64 route takes the JAX package's Ozaki strip route and
    plan (backend, slices and counts equal); Gaussian rows span more bits
    than the slice window, so the port runs the four hi/lo passes and
    holds f64 entry by entry where the JAX package's one pass does not."""
    a, _ = _pair("gaussian", "gaussian", n=420, band=24)
    jc, jres = spgemm_tpu.spgemm_csr(a, tm=tm, aat=aat,
                                     compute_dtype=np.float64)
    pc, pres = pt.spgemm_csr(to_port(a), tm=tm, aat=aat,
                             compute_dtype=torch.float64, device="cpu")
    assert jres.stats["backend"] == pres.stats["backend"] \
        == "ozaki-strip(S=8x8)"
    assert pres.stats["ozaki_passes"] == 4
    assert pc.pattern_equal(jc)
    b = a.transpose() if aat else a
    port_err, jax_err = entry_err(pc, a, b), entry_err(jc, a, b)
    assert port_err <= 1e-14 and port_err <= jax_err, (port_err, jax_err)
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
    """The windowed geometry is infeasible on an arrow pattern: through
    backend="ozaki" both packages fall back to the slab engine (it no
    longer raises) and give the same C; the port's auto f64 router runs
    the strip kernel on the plain plan and gives it too."""
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
    # (r + c) % 7 + 1.5 is not an integer: no f32-exact shortcut; the auto
    # router (strict) takes the strip kernel on the plain strip plan
    assert res.stats["backend"] == "ozaki-strip(S=1x1)"
    assert c64.pattern_equal(exp) and np.array_equal(c64.data, exp.data)


def test_cuda_tile_gate_and_bad_operands():
    # the strip kernel's tiles on CUDA (tm % 8, tn % 128, tk % 16);
    # elsewhere the slab engine runs
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert po.strip_kernel_takes(32, 128, 128, cuda)
    assert po.strip_kernel_takes(64, 128, 128, cuda)
    assert po.strip_kernel_takes(24, 128, 256, cuda)
    assert not po.strip_kernel_takes(12, 128, 128, cuda)  # tm % 8
    assert not po.strip_kernel_takes(16, 128, 64, cuda)   # tn % 128
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


# --- the wgmma kernel's schedule (csrc/ozaki_strip.cu) --------------------

def _wgmma_emulation(av8, a_occ, bv8, b_occ, aptr, ak, slots, *, gm, max_b,
                     max_cblock, block_rows, sa, sb, pmax, grid=5):
    """csrc/ozaki_strip.cu:ozaki_wgmma_kernel in NumPy: per launch height
    (ozaki_grid), persistent CTAs walking items (slot, 128-column chunk,
    row chunk) with a stride of `grid`; per item the slot's pairs found by
    scanning its block's slot words, per pair and 128-deep k chunk the A
    stack (slice s at rows s*h) and the K-major B copies as the TMA boxes
    hold them (zero past tk); each consumer's transposed products D (64 x
    N) += B_t (its 64 rows x 32 k) . stack rows (N x 32 k)^T in wgmma
    windows of up to C slices (C = 2 at h 32, else 4) whose groups start
    at a multiple of C (the first at t), into groups t + s, exact in
    int64; the counts as bf16 products; then the triple-float reduce of
    the groups in order. Returns (c_h, c_m, c_l, c_cnt) like the plain
    version."""
    av8, bv8 = av8.numpy().astype(np.int64), bv8
    a_occ = a_occ.float().numpy()
    bt8, bt_occ = ok.k_major_b_plain(bv8, b_occ)
    bt8, bt_occ = bt8.numpy().astype(np.int64), bt_occ.float().numpy()
    aptr, ak, slots = aptr.numpy(), ak.numpy(), slots.numpy()
    ntp, stack_rows, tk = av8.shape
    tm, tn = a_occ.shape[1], bt_occ.shape[1] // max_b
    n_groups = min(sa + sb - 1, (sa + sb - 2 if pmax is None else pmax) + 1)
    ng = 15 if n_groups > 8 else 8
    cols, parts = ok.ozaki_grid(tm, tn, wide=ng == 15)
    n_slots = -(-gm // block_rows) * max_cblock
    planes = [np.zeros((n_slots, tm, tn), np.float32) for _ in range(4)]
    nkc = -(-tk // 128)
    kpad = nkc * 128
    pad = lambda m: np.concatenate(
        [m, np.zeros(m.shape[:-1] + (kpad - tk,), m.dtype)], axis=-1)
    av8p, a_occp, bt8p, bt_occp = map(pad, (av8, a_occ, bt8, bt_occ))
    for h, row_base, n_rc in parts:
        c = 2 if h == 32 else 4
        n_items = n_slots * cols * n_rc
        for cta in range(grid):
            for item in range(cta, n_items, grid):
                slot, rest = divmod(item, cols * n_rc)
                cc, rc = divmod(rest, n_rc)
                row_off = row_base + rc * h
                blk, s_c = divmod(slot, max_cblock)
                r0, r1 = blk * block_rows, min(blk * block_rows + block_rows,
                                               gm)
                acc = np.zeros((ng, 128, h), np.int64)
                cnt = np.zeros((128, h), np.float32)
                for e in range(aptr[r0] * max_b, aptr[r1] * max_b):
                    if slots[e] != s_c:
                        continue
                    g, y = divmod(e, max_b)
                    ks = ak[g]
                    rows = [s * tm + row_off + r for s in range(sa)
                            for r in range(h)]
                    n_cols = slice(y * tn + cc * 128, y * tn + cc * 128 + 128)
                    for kc in range(nkc):
                        kk = slice(kc * 128, kc * 128 + 128)
                        stack = av8p[g, rows, kk]                 # sa*h x 128
                        cnt += (bt_occp[ks, n_cols, kk]
                                @ a_occp[g, row_off:row_off + h, kk].T)
                        for t in range(sb):
                            col0 = (t * max_b + y) * tn + cc * 128
                            bslot = bt8p[ks, col0:col0 + 128, kk]  # 128 x 128
                            ns = min(sa, n_groups - t)
                            # windows: groups [t, next multiple of c), then
                            # [p, p + c) from there
                            starts = [t] + list(range((t // c + 1) * c, ng, c))
                            for k32 in range(4):
                                ksl = slice(32 * k32, 32 * k32 + 32)
                                for p0 in starts:
                                    s0 = p0 - t
                                    end = min((p0 // c + 1) * c, ng)
                                    r = min(end - p0, 8 - s0,
                                            max(ns - s0, 0))
                                    if s0 >= 8 or r <= 0:
                                        continue
                                    d = (bslot[:, ksl]
                                         @ stack[s0 * h:(s0 + r) * h, ksl].T)
                                    for j in range(r):
                                        acc[p0 + j] += d[:, j * h:
                                                         (j + 1) * h]
                assert np.abs(acc).max(initial=0) < 2 ** 31
                red = ok.triple_float_reduce(torch.from_numpy(
                    acc[None, :n_groups].transpose(0, 1, 3, 2)
                    .astype(np.int32).copy()))
                cs = slice(cc * 128, cc * 128 + 128)
                for plane, v in zip(planes, [x[0].numpy() for x in red]
                                    + [cnt.T]):
                    plane[slot, row_off:row_off + h, cs] = v
    return tuple(torch.from_numpy(p) for p in planes)


def test_k_major_b_copies():
    """The K-major copies the kernel writes first: column (t*max_b + y)*tn
    + n of slab ks holds its tk values k contiguous, as bv8 and b_occ hold
    them n-contiguous."""
    a, b = _pair("gaussian", "gaussian", n=260)
    _, (pa, pb) = _tiles(a, b, 16)
    ops = po.build_ozaki_strip(pa, pb).to_device("cpu")
    bv8, b_occ = ops[2], ops[3]
    bt8, bt_occ = ok.k_major_b_plain(bv8, b_occ)
    assert bt8.shape == (bv8.shape[0], bv8.shape[2], bv8.shape[1])
    assert bt_occ.shape == (b_occ.shape[0], b_occ.shape[2], b_occ.shape[1])
    assert bt8.is_contiguous() and bt_occ.is_contiguous()
    rng = np.random.default_rng(5)
    for ks, k, n in zip(*(rng.integers(0, m, 50) for m in bv8.shape)):
        assert bt8[ks, n, k] == bv8[ks, k, n]
    np.testing.assert_array_equal(bt8.numpy(),
                                  bv8.numpy().transpose(0, 2, 1))
    np.testing.assert_array_equal(
        bt_occ.view(torch.int16).numpy(),
        b_occ.view(torch.int16).numpy().transpose(0, 2, 1))


@pytest.mark.parametrize("tm,pmax,groups", [
    (32, None, 8), (32, 14, 15), (16, None, 8), (16, 14, 15)])
def test_wgmma_schedule_emulation_matches_plain_and_pallas(tm, pmax, groups):
    """The kernel's walk emulated (persistent items, slice ranges per
    wgmma, transposed int32 groups reduced in order) is bit-equal to the
    plain version on h, m, l and the counts, and to the Pallas kernel in
    interpret mode on h, m, l, at 8 and at all 15 pair groups."""
    a, b = _pair("gaussian", "gaussian", n=260, band=20)
    (ja, jb), _ = _tiles(a, b, tm)
    jp = jo.build_ozaki_strip(ja, jb, block_rows=8)
    assert (jp.sa, jp.sb) == (8, 8)
    pp = _port_plan(jp)
    kw = pp.kernel_kwargs()
    jkw = jp.kernel_kwargs()
    if pmax is not None:
        kw["pmax"] = jkw["pmax"] = pmax
    assert min(pp.sa + pp.sb - 1, kw["pmax"] + 1) == groups
    ops = pp.to_device("cpu")
    emu = _wgmma_emulation(*ops, **kw)
    plain = ok.ozaki_strip_numeric_plain(*ops, **kw)
    for x, y in zip(emu, plain):
        assert torch.equal(x, y)
    s = jp.sargs
    exp = ozaki_strip_pallas(
        *map(jnp.asarray, (jp.av8, s.a_occ, jp.bv8, s.b_occ, s.aptr,
                           s.kmin, s.meta)), interpret=True, **jkw)
    g = s.gather_idx
    for x, y in zip(emu[:3], exp[:3]):
        np.testing.assert_array_equal(x.numpy()[g],
                                      np.asarray(y, np.float32)[g])


def test_wgmma_schedule_emulation_at_chunked_tiles():
    """24-row tiles at tn 256 (row chunks of 16 and 8, two 128-column
    chunks) and tk 48 (one k chunk, zero past tk): the emulated walk is
    bit-equal to the plain version."""
    rng = np.random.default_rng(9)
    a = p_banded(rng, 400, 30)
    a = a.with_data(rng.standard_normal(a.nnz))
    for tm, tk, tn in ((24, 128, 256), (32, 48, 128)):
        plan = po.build_ozaki_strip(pt.csr_to_tiles(a, tm, tk),
                                    pt.csr_to_tiles(a, tk, tn))
        ops = plan.to_device("cpu")
        kw = plan.kernel_kwargs()
        emu = _wgmma_emulation(*ops, **kw, grid=3)
        plain = ok.ozaki_strip_numeric_plain(*ops, **kw)
        for x, y in zip(emu, plain):
            assert torch.equal(x, y)


def _reduce_np(groups, *, rests):
    """The kernel's epilogue in NumPy f32 on (n_groups, ...) int32 group
    sums: x = M_p * 2^(-7p) by TwoSum into (h, m, l), with the rests
    ml = f32(M_p - i32(f32(M_p))) or without them (the fast path), and x
    formed as the fast path forms it (bits of 1.5 * 2^(23-7p) plus M_p,
    less 1.5 * 2^(23-7p)) when `rests` is False."""
    f32 = np.float32

    def two_sum(a, b):
        s = f32(a + b)
        bb = f32(s - a)
        return s, f32(f32(a - f32(s - bb)) + f32(b - bb))

    h = np.zeros(groups.shape[1:], f32)
    m = np.zeros_like(h)
    low = np.zeros_like(h)
    for p, mp in enumerate(groups):
        scale = f32(2.0 ** (-7 * p))
        if rests:
            mh = mp.astype(f32)
            ml = (mp - mh.astype(np.int32)).astype(f32)
            terms = (f32(mh * scale), f32(ml * scale))
        else:
            magic = np.int32(((150 - 7 * p) << 23) | 0x400000)
            x = f32((magic + mp).view(f32) - np.array(magic).view(f32))
            terms = (x,)
        for x in terms:
            h, e = two_sum(h, x)
            m, e2 = two_sum(m, e)
            low = f32(low + e2)
    return h, m, low


def test_epilogue_fast_path_is_exact():
    """The Ozaki kernel's fast epilogue (every group sum of a warp within
    [-2^22, 2^22)): the magic-constant scaling equals f32(M_p) * 2^(-7p)
    bit for bit at the range's ends and inside, for p = 0 .. 14, and
    leaving out the +0 rests gives the plain reduce's (h, m, l) bit for
    bit."""
    rng = np.random.default_rng(31)
    edge = np.array([-2 ** 22, -2 ** 22 + 1, -1, 0, 1, 2 ** 22 - 1],
                    np.int32)
    for p in range(15):
        mp = np.concatenate([edge, rng.integers(-2 ** 22, 2 ** 22, 2000,
                                                dtype=np.int32)])
        magic = np.int32(((150 - 7 * p) << 23) | 0x400000)
        x = np.float32((magic + mp).view(np.float32)
                       - np.array(magic).view(np.float32))
        want = np.float32(mp.astype(np.float32) * np.float32(2.0 ** (-7 * p)))
        np.testing.assert_array_equal(x.view(np.uint32), want.view(np.uint32))
    for n_groups in (8, 15):
        groups = rng.integers(-2 ** 22, 2 ** 22, (n_groups, 64, 32),
                              dtype=np.int32)
        groups[:, :4] = 0                       # zero groups
        groups[3, 5] = -(2 ** 22)               # the range's ends
        groups[1, 6] = 2 ** 22 - 1
        fast = _reduce_np(groups, rests=False)
        full = _reduce_np(groups, rests=True)
        plain = ok.triple_float_reduce(torch.from_numpy(groups[None]))
        for f, g, pl in zip(fast, full, plain):
            np.testing.assert_array_equal(f.view(np.uint32),
                                          g.view(np.uint32))
            np.testing.assert_array_equal(f.view(np.uint32),
                                          pl[0].numpy().view(np.uint32))
