"""The port's ESC scan route against the JAX package on the CPU: plan
arrays equal array for array, the plain versions of the three scan
kernels against the Pallas kernels (interpret mode) on the same plan, the
device window combine against the host trim, and the route as a whole
through spgemm_csr, spgemm_esc and EscExecutor.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: integer values keep every partial sum exact in f32, so they
must agree exactly. Gaussian values: the plain versions add in the
reference's order and are expected bit-equal, but XLA may contract or
vectorise the reference's arithmetic differently, so rtol 1e-6 (atol
1e-6*max|y|, for sums that cancel to near zero). The device combine sums
in f32 where the host trim sums in f64: rtol 1e-5. The double-double
route against JAX's: rtol 1e-12 (both are f64-accurate to ~1e-14).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgemm_tpu
import spgemm_tpu.ops.esc as jesc
import spgemm_tpu.utils.native as jnative
from spgemm_tpu.ops.executor import EscExecutor as JEscExecutor
from spgemm_tpu.utils import generators as jgen

import spgemm_tpu_torch as pt
import spgemm_tpu_torch.ops.esc as pesc
import spgemm_tpu_torch.utils.native as pnative
from spgemm_tpu_torch.ops import golden, scan_kernels
from spgemm_tpu_torch.utils import generators as pgen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN_ARRAYS = ("c_indptr", "c_indices", "qv", "meta", "win_rowptr")


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def hub_matrix(values="gaussian", seed=99, n=500):
    """A few hub rows (thousands of products, the native radix and bitmap
    paths) over a sparse random rest (the direct path)."""
    r = np.random.default_rng(seed)
    rows = np.concatenate([np.zeros(900, np.int64), r.integers(0, n, 8000)])
    cols = np.concatenate([r.integers(0, n, 900), r.integers(0, n, 8000)])
    vals = (r.standard_normal(rows.size) if values == "gaussian"
            else r.integers(1, 10, rows.size).astype(np.float64))
    return spgemm_tpu.CSR.from_coo(rows, cols, vals, (n, n))


def band_matrix(values, n=512, half=40, seed=91):
    """The dup-heavy band of tests/test_esc.py:404-415: windows tens of
    rows tall, some taller than COMBINE_K at G=1 (the tail path)."""
    offs = np.arange(-half, half + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(int(keep.sum())) if values == "gaussian"
            else ((r[keep] * 7 + c[keep] * 13) % 9 + 1).astype(np.float64))
    return spgemm_tpu.CSR.from_coo(r[keep], c[keep], vals, (n, n))


def assert_plans_equal(pp, jp, sources=True):
    for f in PLAN_ARRAYS:
        np.testing.assert_array_equal(getattr(pp, f), getattr(jp, f),
                                      err_msg=f)
    assert (pp.shape, pp.nnz_c, pp.num_products, pp.passes,
            pp.group_rows) == (jp.shape, jp.nnz_c, jp.num_products,
                               jp.passes, jp.group_rows)
    np.testing.assert_array_equal(pp.meta16(), jesc.meta16_plane(jp.meta))
    if sources:
        np.testing.assert_array_equal(pp.a_src, jp.a_src)
        np.testing.assert_array_equal(pp.b_src, jp.b_src)
    else:
        assert pp.a_src is None and jp.a_src is None


def assert_same(got, exp, values, rtol=1e-6):
    if values == "integer":
        np.testing.assert_array_equal(got, exp)
    else:
        scale = float(np.abs(exp).max()) or 1.0
        np.testing.assert_allclose(got, exp, rtol=rtol, atol=rtol * scale)


# --- host layer -----------------------------------------------------------------

@pytest.mark.parametrize("keep_sources,group_rows",
                         [(True, 1), (False, 1), (True, 2), (False, 8)])
def test_plan_arrays_match_jax(keep_sources, group_rows):
    a = hub_matrix()
    jp = jesc.build_esc_scan_plan(a, a, keep_sources=keep_sources,
                                  group_rows=group_rows)
    pa = to_port(a)
    pp = pt.build_esc_scan_plan(pa, pa, keep_sources=keep_sources,
                                group_rows=group_rows)
    assert_plans_equal(pp, jp, sources=keep_sources)
    assert pp.qv.shape[0] % pesc.SCAN_BLK == 0


@pytest.mark.parametrize("group_rows", [1, 2, 8])
def test_numpy_fallback_matches_jax_and_native(group_rows):
    a = hub_matrix(seed=3, n=300)
    pa = to_port(a)
    got = pesc._esc_scan_symbolic_numpy(pa, pa, group_rows=group_rows)
    exp = jesc._esc_scan_symbolic_numpy(a, a, group_rows=group_rows)
    native = pnative.esc_scan_symbolic_native(pa, pa, keep_sources=True,
                                              group_rows=group_rows)
    assert got[2] == exp[2] == native[2] and got[8] == exp[8] == native[8]
    for i in (0, 1, 3, 4, 5, 6, 7):
        np.testing.assert_array_equal(got[i], exp[i], err_msg=str(i))
        np.testing.assert_array_equal(native[i], exp[i], err_msg=str(i))


def test_plan_without_native_library_matches_jax(monkeypatch):
    a = hub_matrix(seed=4, n=300)
    monkeypatch.setattr(pnative, "esc_scan_symbolic_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(pnative, "esc_refresh_qv_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(pnative, "esc_refresh_dd_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(pnative, "esc_gather_planes_native",
                        lambda *a, **k: None)
    pa = to_port(a)
    pp = pt.build_esc_scan_plan(pa, pa, group_rows=2)
    monkeypatch.setenv("SPGEMM_TPU_NATIVE", "0")
    jp = jesc.build_esc_scan_plan(a, a, group_rows=2)
    assert_plans_equal(pp, jp)
    new = np.random.default_rng(5).standard_normal(a.nnz)
    # the NumPy value refreshes equal the native ones
    monkeypatch.undo()
    nat = pt.build_esc_scan_plan(pa, pa, group_rows=2)
    np.testing.assert_array_equal(pesc.refresh_qv(pp, new, new),
                                  pesc.refresh_qv(nat, new, new))


def test_value_refreshes_match_jax():
    a = hub_matrix(seed=6, n=300)
    pa = to_port(a)
    jp = jesc.build_esc_scan_plan(a, a)
    pp = pt.build_esc_scan_plan(pa, pa)
    new = np.random.default_rng(7).standard_normal(a.nnz)
    for got, exp in zip(
            pesc.scan_dd_planes(pp, new, new) + pesc.gather_planes(pp, new,
                                                                   new),
            jesc.scan_dd_planes(jp, new, new)
            + jnative.esc_gather_planes_native(jp.a_src, jp.b_src, new, new)):
        np.testing.assert_array_equal(got, exp)
    jp.refresh_values(new, new)
    pp.refresh_values(new, new)
    np.testing.assert_array_equal(pp.qv, jp.qv)


@pytest.mark.parametrize("native", [True, False])
def test_empty_product_plan_matches_jax(native, monkeypatch):
    a = spgemm_tpu.CSR.from_coo(np.array([1]), np.array([2]),
                                np.array([5.0]), (4, 8))
    b = spgemm_tpu.CSR.from_coo(np.array([7]), np.array([0]),
                                np.array([3.0]), (8, 3))
    if not native:
        monkeypatch.setattr(pnative, "esc_scan_symbolic_native",
                            lambda *a, **k: None)
        monkeypatch.setenv("SPGEMM_TPU_NATIVE", "0")
    jp = jesc.build_esc_scan_plan(a, b)
    pp = pt.build_esc_scan_plan(to_port(a), to_port(b))
    assert_plans_equal(pp, jp)
    assert pp.num_products == 0 and pp.qv.shape == (pesc.SCAN_BLK, 128)
    assert pp.win_rowptr.size == 2
    c, _, _ = pt.spgemm_esc(to_port(a), to_port(b), device="cpu")
    assert c.nnz == 0 and c.shape == (4, 3)


def test_choose_group_rows_matches_jax():
    nb, offs = 512, np.arange(-20, 21)
    rr = np.repeat(np.arange(nb), offs.size)
    cc = rr + np.tile(offs, nb)
    keep = (cc >= 0) & (cc < nb)
    band = spgemm_tpu.CSR.from_coo(rr[keep], cc[keep],
                                   np.ones(int(keep.sum())), (nb, nb))
    r = np.random.default_rng(5)
    sparse = spgemm_tpu.CSR.from_coo(r.integers(0, 4096, 8192),
                                     r.integers(0, 4096, 8192),
                                     r.standard_normal(8192), (4096, 4096))
    mid = band_matrix("integer", n=256, half=6)
    for a, exp in ((band, 8), (sparse, 1), (mid, None)):
        got = pesc.choose_group_rows(to_port(a), to_port(a))
        assert got == jesc.choose_group_rows(a, a)
        if exp is not None:
            assert got == exp


def test_suite_matches_run_suite():
    spec = importlib.util.spec_from_file_location(
        "run_suite", os.path.join(REPO, "tools", "run_suite.py"))
    run_suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_suite)
    exp = run_suite.suite(False, n=1024)
    got = pgen.suite(1024)
    assert list(got) == list(exp) == [
        "banded1024", "blockdiag1024", "random1024", "powerlaw1024",
        "rmat1024"]
    for name in exp:
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got[name], f),
                                          getattr(exp[name], f),
                                          err_msg=f"{name}.{f}")


# --- kernels: plain versions against the Pallas kernels --------------------------

def _kernel_plan(values, group_rows):
    a = hub_matrix(values, seed=11, n=400)
    return a, jesc.build_esc_scan_plan(a, a, group_rows=group_rows)


@pytest.mark.parametrize("group_rows", [1, 4])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_scan_matches_pallas(group_rows, values):
    a, jp = _kernel_plan(values, group_rows)
    m16 = jesc.meta16_plane(jp.meta)
    exp = np.asarray(jesc.esc_scan_pallas(
        jnp.asarray(jp.qv), jnp.asarray(m16), passes=jp.passes,
        group_rows=group_rows, interpret=True))
    before = scan_kernels.esc_scan.plain_launches
    got = scan_kernels.esc_scan(torch.from_numpy(jp.qv),
                                torch.from_numpy(m16), passes=jp.passes,
                                group_rows=group_rows)
    assert scan_kernels.esc_scan.plain_launches == before + 1
    assert got.shape == exp.shape == (jp.qv.shape[0] // group_rows, 128)
    assert_same(got.numpy(), exp, values)


@pytest.mark.parametrize("group_rows", [1, 4])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_scan_mul_matches_pallas(group_rows, values):
    a, jp = _kernel_plan(values, group_rows)
    m16 = jesc.meta16_plane(jp.meta)
    av, bv = jnative.esc_gather_planes_native(jp.a_src, jp.b_src, a.data,
                                              a.data)
    exp = np.asarray(jesc.esc_scan_mul_pallas(
        jnp.asarray(av), jnp.asarray(bv), jnp.asarray(m16),
        passes=jp.passes, group_rows=group_rows, interpret=True))
    before = scan_kernels.esc_scan_mul.plain_launches
    got = scan_kernels.esc_scan_mul(
        torch.from_numpy(av), torch.from_numpy(bv), torch.from_numpy(m16),
        passes=jp.passes, group_rows=group_rows)
    assert scan_kernels.esc_scan_mul.plain_launches == before + 1
    assert_same(got.numpy(), exp, values)


@pytest.mark.parametrize("group_rows", [1, 2])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_scan_dd_matches_pallas(group_rows, values):
    a, jp = _kernel_plan(values, group_rows)
    m16 = jesc.meta16_plane(jp.meta)
    hi, lo = jesc.scan_dd_planes(jp, a.data, a.data)
    js, je = jesc.esc_scan_dd_pallas(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(m16),
        passes=jp.passes, group_rows=group_rows, interpret=True)
    before = scan_kernels.esc_scan_dd.plain_launches
    ps, pe = scan_kernels.esc_scan_dd(
        torch.from_numpy(hi), torch.from_numpy(lo), torch.from_numpy(m16),
        passes=jp.passes, group_rows=group_rows)
    assert scan_kernels.esc_scan_dd.plain_launches == before + 1
    assert_same(ps.numpy(), np.asarray(js), values)
    # the value the route uses: s + e in f64
    total = ps.numpy().astype(np.float64) + pe.numpy()
    exp = np.asarray(js, np.float64) + np.asarray(je, np.float64)
    if values == "integer":
        np.testing.assert_array_equal(total, exp)
    else:
        np.testing.assert_allclose(total, exp, rtol=1e-12,
                                   atol=1e-12 * np.abs(exp).max())


def test_wrappers_reject_bad_operands():
    qv = torch.zeros(8, 128)
    meta = torch.zeros(8, 128, dtype=torch.int16)
    with pytest.raises(ValueError, match="meta"):
        scan_kernels.esc_scan(qv, meta.int(), passes=1, group_rows=1)
    with pytest.raises(ValueError, match="plane 1"):
        scan_kernels.esc_scan_mul(qv, qv.double(), meta, passes=1,
                                  group_rows=1)
    with pytest.raises(ValueError, match="group_rows"):
        scan_kernels.esc_scan(qv, meta, passes=1, group_rows=3)
    with pytest.raises(ValueError, match="passes"):
        scan_kernels.esc_scan_dd(qv, qv, meta, passes=8, group_rows=1)


# --- device combine -----------------------------------------------------------------

@pytest.mark.parametrize("group_rows", [1, 4])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_combine_matches_host_trim(group_rows, values):
    a = to_port(band_matrix(values))
    plan = pt.build_esc_scan_plan(a, a, group_rows=group_rows)
    if group_rows == 1:
        assert (np.diff(plan.win_rowptr) > pesc.COMBINE_K).any()
    out = pesc.esc_scan_numeric(plan, device="cpu")
    host = pesc.esc_scan_trim(plan, out)
    res, tail = pesc._combine_apply(plan, out)
    dev = pesc.esc_scan_trim_combined(plan, res, tail)
    assert dev.pattern_equal(host)
    if values == "integer":
        np.testing.assert_array_equal(dev.data, host.data)
    else:
        np.testing.assert_allclose(dev.data, host.data, rtol=1e-5,
                                   atol=1e-7)
    # the combine's index tensors are cached per plan and device
    assert pesc._combine_layout(plan, torch.device("cpu")) is \
        pesc._combine_layout(plan, out.device)
    assert list(plan._combine_dev) == ["cpu"]


def test_dd_combine_exact_on_integers_and_matches_jax():
    ja = band_matrix("integer", n=384)
    a = to_port(ja)
    plan = pt.build_esc_scan_plan(a, a)
    assert (np.diff(plan.win_rowptr) > pesc.COMBINE_K).any()
    c = pesc.esc_scan_dd(plan, a.data, a.data, device="cpu")
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    np.testing.assert_array_equal(got.data, ref.data)
    jc = jesc.esc_scan_dd(jesc.build_esc_scan_plan(ja, ja), ja.data, ja.data)
    np.testing.assert_array_equal(c.data, jc.data)


# --- the route as a whole ------------------------------------------------------------

def _suite_like(kind, values="integer"):
    rng = np.random.default_rng(13)
    a = {"random": lambda: jgen.random_uniform(rng, 2000, 4),
         "powerlaw": lambda: jgen.power_law(rng, 800),
         "rmat": lambda: jgen.rmat(rng, 2048, nnz_per_row=4)}[kind]()
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
    return a


@pytest.mark.parametrize("kind", ["random", "powerlaw", "rmat"])
@pytest.mark.parametrize("aat", [False, True])
def test_spgemm_csr_matches_jax_esc(kind, aat):
    a = _suite_like(kind)
    jc, jres = spgemm_tpu.spgemm_csr(a, aat=aat)
    before = scan_kernels.esc_scan.plain_launches
    pc, pres = pt.spgemm_csr(to_port(a), aat=aat, device="cpu")
    assert scan_kernels.esc_scan.plain_launches == before + 1
    assert pres.stats["backend"] == jres.stats["backend"] == "esc"
    assert pres.c is None and isinstance(pres.schedule, pesc.ScanPlan)
    assert pc.pattern_equal(jc)
    np.testing.assert_array_equal(pc.data, jc.data)
    for k in ("num_pairs", "nnzC", "nnzCub", "numblkC"):
        assert pres.stats[k] == jres.stats[k], k
    ref = golden.spgemm_scipy(to_port(a), to_port(a).transpose() if aat
                              else to_port(a))
    got = golden.drop_explicit_zeros(pc)
    assert got.pattern_equal(ref) and np.array_equal(got.data, ref.data)


@pytest.mark.parametrize("kind", ["random", "rmat"])
def test_f64_dd_route_matches_jax(kind):
    a = _suite_like(kind, "gaussian")
    jc, jres = spgemm_tpu.spgemm_csr(a, backend="esc",
                                     compute_dtype=jnp.float64)
    before = scan_kernels.esc_scan_dd.plain_launches
    pc, pres = pt.spgemm_csr(to_port(a), compute_dtype=torch.float64,
                             device="cpu")
    assert scan_kernels.esc_scan_dd.plain_launches == before + 1
    assert pres.stats["backend"] == "esc"
    assert pc.pattern_equal(jc)
    np.testing.assert_allclose(pc.data, jc.data, rtol=1e-12, atol=1e-13)
    pc2, _ = pt.spgemm_csr(to_port(a), backend="esc",
                           compute_dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(pc2.data, pc.data)


# spgemm(backend="esc") on tiles: CSR round trip, C back in A's tile rows
# and B's tile columns (spgemm_tpu/ops/spgemm.py:271-291). Integer values
# are exact; Gaussian f32 within rtol 1e-5 (atol 1e-6*max|C|); f64 within
# the double-double route's rtol 1e-10, atol 1e-11 (tests/test_esc.py:334)
@pytest.mark.parametrize("kind", ["random", "rmat"])
@pytest.mark.parametrize("values,f64", [("integer", False),
                                        ("gaussian", False),
                                        ("gaussian", True)])
def test_spgemm_tiles_esc_matches_jax(kind, values, f64):
    import spgemm_tpu.models.tile as jtile

    a = _suite_like(kind, values)
    jres = spgemm_tpu.spgemm(jtile.csr_to_tiles(a, 16, 128),
                             jtile.csr_to_tiles(a, 128, 128), backend="esc",
                             compute_dtype=jnp.float64 if f64
                             else jnp.float32)
    pa = to_port(a)
    wrapper = scan_kernels.esc_scan_dd if f64 else scan_kernels.esc_scan
    before = wrapper.plain_launches
    pres = pt.spgemm(pt.csr_to_tiles(pa, 16, 128),
                     pt.csr_to_tiles(pa, 128, 128), backend="esc",
                     compute_dtype=torch.float64 if f64 else torch.float32,
                     device="cpu")
    assert wrapper.plain_launches == before + 1
    assert isinstance(pres.schedule, pesc.ScanPlan)
    assert (pres.c.tm, pres.c.tn) == (jres.c.tm, jres.c.tn) == (16, 128)
    # the f32 scan route also counts its copies (h2d_bytes, d2h_bytes)
    counters = set() if f64 else {"h2d_bytes", "d2h_bytes"}
    assert sorted(pres.stats) == sorted(set(jres.stats) | counters)
    assert pres.stats["backend"] == jres.stats["backend"] == "esc"
    for k in ("num_pairs", "numblkC_candidate", "numblkC", "nnzC"):
        assert pres.stats[k] == jres.stats[k], k
    pc, jc = pres.c.to_csr(), jres.c.to_csr()
    assert pc.pattern_equal(jc)
    if values == "integer":
        np.testing.assert_array_equal(pc.data, jc.data)
    elif f64:
        np.testing.assert_allclose(pc.data, jc.data, rtol=1e-10, atol=1e-11)
    else:
        np.testing.assert_allclose(pc.data, jc.data, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(jc.data).max()))


def test_f64_integer_data_takes_the_exact_f32_route():
    a = to_port(_suite_like("random"))
    before = (scan_kernels.esc_scan.plain_launches,
              scan_kernels.esc_scan_dd.plain_launches)
    c, res = pt.spgemm_csr(a, compute_dtype=torch.float64, device="cpu")
    assert res.stats["backend"] == "esc(f64-exact-int)"
    assert (scan_kernels.esc_scan.plain_launches,
            scan_kernels.esc_scan_dd.plain_launches) == (before[0] + 1,
                                                         before[1])
    ref = golden.spgemm_scipy(a, a)
    assert np.array_equal(golden.drop_explicit_zeros(c).data, ref.data)


def test_auto_router_agrees_with_jax():
    rng = np.random.default_rng(17)
    mats = list(jgen.__dict__["banded"](rng, 700, 48) for _ in range(1))
    mats += [_suite_like(k) for k in ("random", "powerlaw", "rmat")]
    mats += [jgen.block_diag(rng, 1024), band_matrix("integer", n=256,
                                                     half=6)]
    seen = set()
    for a in mats:
        _, jres = spgemm_tpu.spgemm_csr(a)
        _, pres = pt.spgemm_csr(to_port(a), device="cpu")
        jb = str(jres.stats["backend"])
        assert pres.stats["backend"] == ("esc" if jb == "esc" else "strip")
        seen.add(pres.stats["backend"])
    assert seen == {"esc", "strip"}


def test_structured_non_integer_f64_raises():
    # auto f64 routing runs the Ozaki route on this structured input; f64
    # through backend="strip" no longer raises: the port's strip route is
    # float32, so the router falls back to the slab route in f64, which
    # matches the JAX package's f64 product
    ja = band_matrix("gaussian", n=300, half=20)
    a = to_port(ja)
    assert pt.spgemm_csr(a, device="cpu")[1].stats["backend"] == "strip"
    _, res = pt.spgemm_csr(a, compute_dtype=torch.float64, device="cpu")
    assert res.stats["backend"] == "ozaki-strip(S=8x8)"
    c, res = pt.spgemm_csr(a, compute_dtype=torch.float64, backend="strip",
                           device="cpu")
    assert res.stats["backend"] == "gustavson(strip-fallback: float64)"
    exp, _ = spgemm_tpu.spgemm_csr(ja, compute_dtype=np.float64,
                                   backend="strip")
    assert c.pattern_equal(exp)
    # f64 summed in another order: rtol 1e-12, atol 1e-13*max|C|
    np.testing.assert_allclose(c.data, exp.data, rtol=1e-12,
                               atol=1e-13 * np.abs(exp.data).max())


def test_digit_mode_and_bad_plans_raise():
    # digit mode runs and matches the JAX package's digit mode
    ja = _suite_like("random")
    a = to_port(ja)
    c, _, plan = pt.spgemm_esc(a, a, mode="digit", device="cpu")
    jc, _, _ = jesc.spgemm_esc(ja, ja, mode="digit")
    assert isinstance(plan, pt.EscPlan) and c.pattern_equal(jc)
    np.testing.assert_array_equal(c.data, jc.data)
    with pytest.raises(TypeError, match="ScanPlan"):
        pt.spgemm_esc(a, a, plan=object(), device="cpu")
    with pytest.raises(TypeError, match="ScanPlan"):
        pt.EscExecutor(object(), device="cpu")
    with pytest.raises(ValueError, match="mode"):
        pt.EscExecutor(pt.build_esc_scan_plan(a, a), mode="x", device="cpu")


def test_spgemm_esc_reuses_plan_for_new_values():
    ja = _suite_like("rmat")
    a = to_port(ja)
    c, tms, plan = pt.spgemm_esc(a, a, device="cpu")
    # route_ms: choose_group_rows, run where the plan is built;
    # download_ms: the copies inside compact_ms
    assert set(tms) == {"route_ms", "symbolic_ms", "upload_ms",
                        "numeric_ms", "compact_ms", "download_ms"}
    jc, _, _ = jesc.spgemm_esc(ja, ja)
    np.testing.assert_array_equal(c.data, jc.data)
    c2, _, plan2 = pt.spgemm_esc(a, a, plan=plan, device="cpu")
    assert plan2 is plan and np.array_equal(c2.data, c.data)


# --- EscExecutor ---------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["premul", "mul"])
def test_esc_executor_matches_jax(mode):
    ja = _suite_like("powerlaw")
    a = to_port(ja)
    jplan = jesc.build_esc_scan_plan(ja, ja)
    pplan = pt.build_esc_scan_plan(a, a)
    jex = JEscExecutor(jplan, mode=mode)
    pex = pt.EscExecutor(pplan, mode=mode, device="cpu")
    launches = {"premul": scan_kernels.esc_scan,
                "mul": scan_kernels.esc_scan_mul}[mode]
    before = launches.plain_launches
    exp = jex.run_csr()
    for _ in range(2):  # repeated runs on resident planes
        got = pex.run_csr()
        assert got.pattern_equal(exp)
        np.testing.assert_array_equal(got.data, exp.data)
    assert launches.plain_launches == before + 2
    np.testing.assert_array_equal(pex.run().numpy(), np.asarray(jex.run()))

    new = np.random.default_rng(19).standard_normal(ja.nnz)
    qv_before = pplan.qv.copy()
    jex.update_values(new, new)
    pex.update_values(new, new)
    np.testing.assert_array_equal(pplan.qv, qv_before)  # plan untouched
    got, exp = pex.run_csr(), jex.run_csr()
    assert got.pattern_equal(exp)
    np.testing.assert_allclose(got.data, exp.data, rtol=1e-6,
                               atol=1e-6 * np.abs(exp.data).max())
    with pytest.raises(ValueError, match="smaller"):
        pex.update_values(new[:3], new)


def test_esc_executor_needs_sources_and_a_card():
    a = to_port(_suite_like("random"))
    plan = pt.build_esc_scan_plan(a, a, keep_sources=False)
    ex = pt.EscExecutor(plan, device="cpu")
    with pytest.raises(ValueError, match="keep_sources"):
        ex.update_values(a.data, a.data)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ex.time_numeric()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.EscExecutor(plan)
