"""The port's ESC digit mode against the JAX package on the CPU: the
digit plan (EscPlan) array for array on the native and the NumPy path,
the one-hot contraction (esc_digit_reduce) on the same streams, and
spgemm_esc(mode="digit") as a whole, in f32 and f64.

Tolerances: integer values keep every partial sum exact in f32, so they
must agree exactly. Gaussian values: both sides contract in full f32 but
XLA and torch's bmm may sum in another order, so rtol 1e-6 (atol
1e-6*max|out| for sums that cancel to near zero). f64: rtol 1e-12, atol
1e-13*max|C| (f64 summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgemm_tpu
import spgemm_tpu.ops.esc as jesc

import spgemm_tpu_torch as pt
import spgemm_tpu_torch.ops.esc as pesc
import spgemm_tpu_torch.utils.native as pnative
from spgemm_tpu_torch.ops import golden

CLASS_ARRAYS = ("av", "bv", "slot", "base", "glen")


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def rand_csr(m, n, nnz, seed, values="gaussian"):
    r = np.random.default_rng(seed)
    vals = (r.standard_normal(nnz) if values == "gaussian"
            else r.integers(1, 10, nnz).astype(np.float64))
    return spgemm_tpu.CSR.from_coo(r.integers(0, m, nnz),
                                   r.integers(0, n, nnz), vals, (m, n))


def wide_row(values="gaussian"):
    """tests/test_esc.py:63-70: one A row with 3000 nonzeros, so a C row
    wider than a 2048-slot group."""
    m, k, n = 32, 3000, 5000
    r = np.concatenate([np.zeros(3000, np.int64),
                        np.arange(1, m, dtype=np.int64)])
    c = np.concatenate([np.arange(3000), np.arange(1, m, dtype=np.int64)])
    rng = np.random.default_rng(5)
    vals = (rng.standard_normal(r.size) if values == "gaussian"
            else rng.integers(1, 10, r.size).astype(np.float64))
    a = spgemm_tpu.CSR.from_coo(r, c, vals, (m, k))
    return a, rand_csr(k, n, 25000, 6, values)


def band(values="gaussian", n=400, half=40):
    """A dense band: ~80 products per output, so intervals past W_MAX
    split into sibling groups that esc_trim sums."""
    offs = np.arange(-half, half + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    rng = np.random.default_rng(8)
    vals = (rng.standard_normal(int(keep.sum())) if values == "gaussian"
            else rng.integers(1, 10, int(keep.sum())).astype(np.float64))
    a = spgemm_tpu.CSR.from_coo(r[keep], c[keep], vals, (n, n))
    return a, a


def empty():
    a = spgemm_tpu.CSR.from_coo(np.array([1]), np.array([2]),
                                np.array([5.0]), (4, 8))
    b = spgemm_tpu.CSR.from_coo(np.array([7]), np.array([0]),
                                np.array([3.0]), (8, 3))
    return a, b


CASES = {
    "square": lambda v="gaussian": (rand_csr(300, 300, 3000, 1, v),) * 2,
    "rectangular": lambda v="gaussian": (rand_csr(200, 150, 1500, 2, v),
                                         rand_csr(150, 260, 1400, 3, v)),
    "empty": lambda v="gaussian": empty(),
    "wide_row": wide_row,
    "band": band,
}


def assert_plans_equal(pp, jp):
    np.testing.assert_array_equal(pp.c_indptr, jp.c_indptr)
    np.testing.assert_array_equal(pp.c_indices, jp.c_indices)
    assert (pp.shape, pp.nnz_c, pp.num_products, pp.s_slots) == (
        jp.shape, jp.nnz_c, jp.num_products, jp.s_slots)
    assert len(pp.classes) == len(jp.classes)
    for pc, jc in zip(pp.classes, jp.classes):
        assert pc["w"] == jc["w"]
        for f in CLASS_ARRAYS:
            np.testing.assert_array_equal(pc[f], jc[f], err_msg=f)
    for got, exp in zip(pp.a_src + pp.b_src, jp.a_src + jp.b_src):
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_digit_plan_matches_jax(case, native, monkeypatch):
    a, b = CASES[case]()
    if not native:
        monkeypatch.setattr(pnative, "esc_symbolic_native",
                            lambda *a, **k: None)
        monkeypatch.setenv("SPGEMM_TPU_NATIVE", "0")
    jp = jesc.build_esc_plan(a, b)
    pp = pt.build_esc_plan(to_port(a), to_port(b))
    assert_plans_equal(pp, jp)
    if case == "wide_row":
        assert max(np.diff(pp.c_indptr)) > pesc.S_SLOTS
    if case == "band":
        assert any(np.unique(c["base"]).size < c["base"].size
                   or c["w"] == pesc.W_MAX for c in pp.classes)
    if case == "empty":
        assert pp.num_products == 0 and pp.nnz_c == 0


def test_native_and_numpy_symbolic_agree():
    a, b = wide_row()
    pa, pb = to_port(a), to_port(b)
    got = pesc._esc_symbolic_numpy(pa, pb, pesc.S_SLOTS, pesc.W_MAX)
    nat = pnative.esc_symbolic_native(pa, pb, pesc.S_SLOTS, pesc.W_MAX,
                                      pesc.W_MIN)
    assert got[2] == nat[2]
    for i in (0, 1, 3, 4, 5, 6, 8, 9):
        np.testing.assert_array_equal(got[i], nat[i], err_msg=str(i))


@pytest.mark.parametrize("values", ["integer", "gaussian"])
@pytest.mark.parametrize("case", ["square", "wide_row", "band"])
def test_digit_reduce_matches_jax(case, values):
    a, b = CASES[case](values)
    jp = jesc.build_esc_plan(a, b)
    for cls in jp.classes:
        av = cls["av"].astype(np.float32)
        bv = cls["bv"].astype(np.float32)
        exp = np.asarray(jesc.esc_digit_reduce(
            jnp.asarray(av), jnp.asarray(bv), jnp.asarray(cls["slot"])))
        got = pesc.esc_digit_reduce(torch.from_numpy(av),
                                    torch.from_numpy(bv),
                                    torch.from_numpy(cls["slot"])).numpy()
        assert got.shape == exp.shape == (cls["slot"].shape[0],
                                          pesc.S_SLOTS)
        if values == "integer":
            np.testing.assert_array_equal(got, exp)
        else:
            np.testing.assert_allclose(
                got, exp, rtol=1e-6, atol=1e-6 * np.abs(exp).max())


def test_digit_reduce_chunking_changes_nothing():
    a, b = band("integer")
    pp = pt.build_esc_plan(to_port(a), to_port(b))
    for d in pp.to_device("cpu"):
        whole = pesc.esc_digit_reduce(d["av"], d["bv"], d["slot"])
        # a budget below one group's temporaries: one group per chunk
        for budget in (1, 3 * d["slot"].shape[1] * 100 * 5):
            assert torch.equal(pesc.esc_digit_reduce(
                d["av"], d["bv"], d["slot"], budget_bytes=budget), whole)


@pytest.mark.parametrize("values", ["integer", "gaussian"])
@pytest.mark.parametrize("case", ["square", "rectangular", "wide_row",
                                  "band", "empty"])
def test_spgemm_esc_digit_matches_jax_f32(case, values):
    a, b = CASES[case](values)
    jc, _, _ = jesc.spgemm_esc(a, b, mode="digit")
    c, tms, plan = pt.spgemm_esc(to_port(a), to_port(b), mode="digit",
                                 device="cpu")
    assert isinstance(plan, pt.EscPlan)
    assert set(tms) == {"symbolic_ms", "upload_ms", "numeric_ms",
                        "compact_ms"}
    assert c.pattern_equal(jc)
    if values == "integer":
        np.testing.assert_array_equal(c.data, jc.data)
        ref = golden.drop_explicit_zeros(
            golden.spgemm_scipy(to_port(a), to_port(b)))
        got = golden.drop_explicit_zeros(c)
        assert got.pattern_equal(ref)
        np.testing.assert_array_equal(got.data, ref.data)
    elif jc.nnz:
        np.testing.assert_allclose(c.data, jc.data, rtol=1e-6,
                                   atol=1e-6 * np.abs(jc.data).max())


@pytest.mark.parametrize("case", ["square", "rectangular", "wide_row",
                                  "band"])
def test_spgemm_esc_digit_matches_jax_f64(case):
    a, b = CASES[case]()
    with jax.enable_x64(True):
        jc, _, _ = jesc.spgemm_esc(a, b, dtype=np.float64, mode="digit")
    c, _, _ = pt.spgemm_esc(to_port(a), to_port(b), dtype=torch.float64,
                            mode="digit", device="cpu")
    assert c.pattern_equal(jc)
    np.testing.assert_allclose(c.data, jc.data, rtol=1e-12,
                               atol=1e-13 * np.abs(jc.data).max())


def test_esc_plan_decides_the_mode():
    a, b = CASES["square"]()
    pa, pb = to_port(a), to_port(b)
    plan = pt.build_esc_plan(pa, pb)
    c_auto, _, p2 = pt.spgemm_esc(pa, pb, plan=plan, device="cpu")
    c_digit, _, _ = pt.spgemm_esc(pa, pb, mode="digit", device="cpu")
    assert p2 is plan and c_auto == c_digit
    with pytest.raises(ValueError, match="EscPlan but mode='scan'"):
        pt.spgemm_esc(pa, pb, plan=plan, mode="scan", device="cpu")
    splan = pt.build_esc_scan_plan(pa, pb)
    with pytest.raises(ValueError, match="ScanPlan but mode='digit'"):
        pt.spgemm_esc(pa, pb, plan=splan, mode="digit", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        pt.spgemm_esc(pa, pb, mode="hash", device="cpu")


def test_refresh_values_matches_jax():
    a, b = CASES["rectangular"]()
    jp = jesc.build_esc_plan(a, b)
    pp = pt.build_esc_plan(to_port(a), to_port(b))
    rng = np.random.default_rng(9)
    na, nb = rng.standard_normal(a.nnz), rng.standard_normal(b.nnz)
    jp.refresh_values(na, nb)
    pp.refresh_values(na, nb)
    assert_plans_equal(pp, jp)
    c, _, _ = pt.spgemm_esc(to_port(a), to_port(b), plan=pp, device="cpu")
    ref = golden.spgemm_scipy(to_port(a).with_data(na),
                              to_port(b).with_data(nb))
    got = golden.drop_explicit_zeros(c)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5,
                               atol=1e-6 * np.abs(ref.data).max())


def test_device_timers_need_a_card():
    a, b = CASES["square"]()
    pa, pb = to_port(a), to_port(b)
    for plan in (pt.build_esc_plan(pa, pb), pt.build_esc_scan_plan(pa, pb)):
        with pytest.raises(RuntimeError, match="CUDA"):
            pesc.time_esc_any(plan, device="cpu")
