"""The port's Gustavson slab route and dense route against the JAX
package on the CPU: the slab plan array for array, the numeric step on
the reference's own plan (GustavsonPlan.from_numpy), and
spgemm(backend="gustavson" | "dense") end to end, f32 and f64.

Neither route reaches a Pallas kernel: the JAX package runs them in XLA
on the CPU. Tolerances: integer values exact; Gaussian values rtol 1e-5,
atol 1e-6*max|C| in f32 (summation order differs); rtol 1e-12, atol
1e-13*max|C| in f64.
"""

import dataclasses

import numpy as np
import pytest
import torch

import spgemm_tpu
import spgemm_tpu.models.tile as jtile
from spgemm_tpu.ops import gustavson as jg
from spgemm_tpu.utils.generators import banded as j_banded

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import gustavson as pg


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def _random(rng, m, n, density=0.06):
    nnz = int(m * n * density)
    return spgemm_tpu.CSR.from_coo(
        rng.integers(0, m, nnz), rng.integers(0, n, nnz),
        rng.integers(1, 10, nnz).astype(np.float64), (m, n))


def _pair(kind: str, values: str, rng):
    if kind == "banded":
        a = j_banded(rng, 300, 20)
        b = a
    else:  # rectangular A (100x70) times B (70x120)
        a, b = _random(rng, 100, 70), _random(rng, 70, 120)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
        b = a if kind == "banded" else b.with_data(
            rng.standard_normal(b.nnz))
    return a, b


def _tiles(a, b, tm, tn):
    return ((jtile.csr_to_tiles(a, tm, tn), jtile.csr_to_tiles(b, tn, tn)),
            (pt.csr_to_tiles(to_port(a), tm, tn),
             pt.csr_to_tiles(to_port(b), tn, tn)))


def _assert_close(got, exp, values, f64=False):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    if values == "integer":
        np.testing.assert_array_equal(got, exp)
    else:
        scale = float(np.abs(exp).max()) if exp.size else 0.0
        rtol, atol = (1e-12, 1e-13) if f64 else (1e-5, 1e-6)
        np.testing.assert_allclose(got, exp, rtol=rtol, atol=atol * scale)


@pytest.mark.parametrize("kind", ["banded", "rect"])
@pytest.mark.parametrize("tiles", [(16, 16), (8, 16), (16, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plan_arrays_equal_jax(kind, tiles, dtype):
    a, b = _pair(kind, "gaussian", np.random.default_rng(3))
    (ja, jb), (pa, pb) = _tiles(a, b, *tiles)
    jp = jg.build_gustavson_plan(ja, jb, dtype=dtype)
    pp = pg.build_gustavson_plan(pa, pb, dtype=dtype)
    for f in dataclasses.fields(jp):
        x, y = getattr(jp, f.name), getattr(pp, f.name)
        if f.name.endswith("_ms"):
            continue
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name
    assert pp.padding_ratio() == jp.padding_ratio()


@pytest.mark.parametrize("a_slabs,values", [(False, True), (True, False)])
def test_plan_flags_equal_jax(a_slabs, values):
    a, b = _pair("banded", "integer", np.random.default_rng(4))
    (ja, jb), (pa, pb) = _tiles(a, b, 16, 16)
    jp = jg.build_gustavson_plan(ja, jb, a_slabs=a_slabs, values=values)
    pp = pg.build_gustavson_plan(pa, pb, a_slabs=a_slabs, values=values)
    for name in ("a3_val", "a3_occ", "b3_val", "b3_occ", "seg"):
        x, y = getattr(jp, name), getattr(pp, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert np.array_equal(x, y), name


@pytest.mark.parametrize("values", ["integer", "gaussian"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numeric_on_jax_plan(values, dtype):
    a, b = _pair("banded", values, np.random.default_rng(5))
    (ja, jb), _ = _tiles(a, b, 16, 16)
    jp = jg.build_gustavson_plan(ja, jb, dtype=dtype)
    kw = dict(gk=jp.gk, max_a=jp.max_a, max_b=jp.max_b, tm=jp.tm, tn=jp.tn,
              nt_c=jp.nt_c)
    jv, jc = jg.gustavson_numeric(jp.a3_val, jp.a3_occ, jp.b3_val,
                                  jp.b3_occ, jp.seg, **kw,
                                  acc_dtype=np.dtype(dtype))
    pp = pg.GustavsonPlan.from_numpy(dataclasses.asdict(jp))
    pv, pc = pg.gustavson_numeric(*pp.to_device("cpu"), **pp.numeric_kwargs())
    assert pv.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
    _assert_close(pv.numpy(), jv, values, f64=dtype == np.float64)
    np.testing.assert_array_equal(pc.numpy() > 0, np.asarray(jc) > 0)


def test_to_dense_padded_equals_jax(make_random_csr):
    a = make_random_csr(45, 70, 0.1)
    a = a.with_data(np.where(np.arange(a.nnz) % 5 == 0, 0.0, a.data))
    for tm, tn in ((8, 16), (16, 32)):
        jt_, pt_ = jtile.csr_to_tiles(a, tm, tn), pt.csr_to_tiles(
            to_port(a), tm, tn)
        for dt in (np.float32, np.float64):
            x, y = jt_.to_dense_padded(dt), pt_.to_dense_padded(dt)
            assert x.dtype == y.dtype and np.array_equal(x, y)
        x, y = jt_.occ_dense_padded(), pt_.occ_dense_padded()
        assert x.dtype == y.dtype and np.array_equal(x, y)
        # explicit zeros are structural
        assert int(y.sum()) == a.nnz


@pytest.mark.parametrize("backend", ["gustavson", "dense"])
@pytest.mark.parametrize("kind", ["banded", "rect"])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_spgemm_backend_matches_jax(backend, kind, values):
    a, b = _pair(kind, values, np.random.default_rng(6))
    (ja, jb), (pa, pb) = _tiles(a, b, 8, 16)
    jres = spgemm_tpu.spgemm(ja, jb, backend=backend)
    pres = pt.spgemm(pa, pb, backend=backend, device="cpu")
    jc, pc = jres.c.to_csr(), pres.c.to_csr()
    assert pc.pattern_equal(jc)
    _assert_close(pc.data, jc.data, values)
    assert pres.stats == pytest.approx(jres.stats)


@pytest.mark.parametrize("backend", ["gustavson", "dense"])
def test_f64_backend_matches_jax(backend):
    a, b = _pair("banded", "gaussian", np.random.default_rng(7))
    (ja, jb), (pa, pb) = _tiles(a, b, 16, 16)
    jres = spgemm_tpu.spgemm(ja, jb, backend=backend,
                             compute_dtype=np.float64)
    pres = pt.spgemm(pa, pb, backend=backend, compute_dtype=torch.float64,
                     device="cpu")
    jc, pc = jres.c.to_csr(), pres.c.to_csr()
    assert pc.pattern_equal(jc)
    np.testing.assert_allclose(pc.data, jc.data, rtol=1e-12,
                               atol=1e-13 * np.abs(jc.data).max())
    assert pres.stats["backend"] == backend
    if backend == "gustavson":
        assert pres.schedule.dtype == np.float64


def test_f64_through_the_router_runs_gustavson():
    """f64 on backend auto / strip / gustavson follows the router: the
    port's strip route is float32, dense is too, so the slab route runs
    (in f64, as the JAX package does with x64 on)."""
    a, b = _pair("banded", "gaussian", np.random.default_rng(8))
    (ja, jb), (pa, pb) = _tiles(a, b, 16, 16)
    exp = spgemm_tpu.spgemm(ja, jb, backend="gustavson",
                            compute_dtype=np.float64).c.to_csr()
    for backend, name in (("auto", "gustavson"),
                          ("strip", "gustavson(strip-fallback: float64)"),
                          ("gustavson", "gustavson")):
        res = pt.spgemm(pa, pb, backend=backend, compute_dtype=torch.float64,
                        device="cpu")
        assert res.stats["backend"] == name
        got = res.c.to_csr()
        assert got.pattern_equal(exp)
        np.testing.assert_allclose(got.data, exp.data, rtol=1e-12,
                                   atol=1e-13 * np.abs(exp.data).max())


def test_empty_product():
    e = pt.CSR.from_coo([], [], np.zeros(0), (40, 40))
    for backend in ("gustavson", "dense"):
        res = pt.spgemm(pt.csr_to_tiles(e, 8, 16), pt.csr_to_tiles(e, 16, 16),
                        backend=backend, device="cpu")
        assert res.c.nnz == 0 and res.stats["numblkC"] == 0


def test_full_fp32_restores_the_callers_setting():
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    try:
        mm.fp32_precision = "tf32"
        with pg.full_fp32():
            assert mm.fp32_precision == "ieee"
        assert mm.fp32_precision == "tf32"
        with pytest.raises(RuntimeError, match="inside"):
            with pg.full_fp32():
                raise RuntimeError("inside")
        assert mm.fp32_precision == "tf32"
    finally:
        mm.fp32_precision = prev
