"""The port's f64 Ozaki slab engine and OzakiExecutor against the JAX
package on the CPU: OzakiPlan array for array, ozaki_core on the
reference's own plan (OzakiPlan.from_numpy) against its `_ozaki_jit`,
spgemm_ozaki's fallback from the strip route, the f64 auto router, and
the executor.

No Pallas kernel is on these paths: the JAX package runs the slab engine
in XLA on the CPU. Tolerances: none on (h, m, l, counts). Both sides form
the int32 slice sums exactly (the port as f32 products below 2^24, cast
to int32) and run the same TwoSum sequence elementwise, so the planes
must be bit-equal (torch.equal) and C's values equal to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import spgemm_tpu
import spgemm_tpu.models.tile as jtile
from spgemm_tpu.ops import ozaki as jo
from spgemm_tpu.ops.executor import OzakiExecutor as JOzakiExecutor
from spgemm_tpu.utils.generators import banded as j_banded

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import ozaki as po

PLAN_FIELDS = ("a_sl", "b_sl", "ea", "eb", "perm", "bounds", "a_occ",
               "b_occ")


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


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
    raise ValueError(kind)


def _tiles(kind: str, tm: int = 16, tn: int = 16, seed: int = 3):
    rng = np.random.default_rng(seed)
    a = j_banded(rng, 300, 20)
    a = a.with_data(_values(kind, a.nnz, rng))
    return (a, (jtile.csr_to_tiles(a, tm, tn), jtile.csr_to_tiles(a, tn, tn)),
            (pt.csr_to_tiles(to_port(a), tm, tn),
             pt.csr_to_tiles(to_port(a), tn, tn)))


def _arrow(n: int = 4096):
    """One dense tile-row spanning every k: no windowed strip plan."""
    r = np.concatenate([np.zeros(n // 8, np.int64),
                        np.arange(n, dtype=np.int64)])
    c = np.concatenate([np.arange(0, n, 8, dtype=np.int64),
                        np.arange(n, dtype=np.int64)])
    return spgemm_tpu.CSR.from_coo(
        r, c, ((r + c) % 7 + 1).astype(np.float64) + 0.5, (n, n))


def _jax_core(jp):
    b = jp.base
    return jo._ozaki_jit(jp.a_sl, jp.b_sl, jp.a_occ, jp.b_occ, b.seg,
                         jp.perm, jp.bounds, gk=b.gk, max_a=b.max_a,
                         max_b=b.max_b, tm=b.tm, tn=b.tn, nt_c=b.nt_c,
                         sa=jp.sa, sb=jp.sb)


def _port_plan(jp):
    return po.OzakiPlan.from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


@pytest.mark.parametrize("kind", ["integer", "gaussian", "wide-int", "wild"])
@pytest.mark.parametrize("tiles", [(16, 16), (8, 16), (32, 128)])
def test_plan_arrays_equal_jax(kind, tiles):
    _, (ja, jb), (pa, pb) = _tiles(kind, *tiles)
    jp = jo.build_ozaki_plan(ja, jb)
    pp = po.build_ozaki_plan(pa, pb)
    for name in PLAN_FIELDS:
        x, y = getattr(jp, name), getattr(pp, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name
    assert (pp.sa, pp.sb) == (jp.sa, jp.sb)
    assert pp.base.a3_occ is None and pp.base.b3_occ is None
    for name in ("seg", "ctrow", "ctcol"):
        assert np.array_equal(getattr(pp.base, name), getattr(jp.base, name))
    assert (pp.nt_c, pp.num_pairs, pp.padding_ratio()) == \
        (jp.nt_c, jp.num_pairs, jp.padding_ratio())


@pytest.mark.parametrize("kind", ["integer", "gaussian", "wide-int", "wild"])
@pytest.mark.parametrize("tiles", [(16, 16), (8, 16)])
def test_core_bit_equal_to_jax_on_its_plan(kind, tiles):
    _, (ja, jb), _ = _tiles(kind, *tiles)
    jp = jo.build_ozaki_plan(ja, jb)
    pp = _port_plan(jp)
    got = po.ozaki_core(*pp.to_device("cpu"), **pp.core_kwargs())
    exp = _jax_core(jp)
    for g, e, name in zip(got, exp, "hmlc"):
        assert torch.equal(g, torch.from_numpy(np.array(e))), name
    cube = po.ozaki_assemble(pp, *got, (ja.m, jb.n))
    np.testing.assert_array_equal(cube, jo.ozaki_assemble(jp, *exp,
                                                          (ja.m, jb.n)))


def test_slab_route_on_tiles_matches_jax():
    """Where the strip route is infeasible both packages take the slab
    engine and name it "ozaki(S=..)(xla-fallback)"."""
    a = _arrow()
    ja, jb = jtile.csr_to_tiles(a, 32, 128), jtile.csr_to_tiles(a, 128, 128)
    pa = pt.csr_to_tiles(to_port(a), 32, 128)
    pb = pt.csr_to_tiles(to_port(a), 128, 128)
    jres = spgemm_tpu.spgemm_ozaki(ja, jb)
    pres = pt.spgemm_ozaki(pa, pb, device="cpu")
    assert pres.stats["backend"] == jres.stats["backend"] \
        == "ozaki(S=1x1)(xla-fallback)"
    assert isinstance(pres.schedule, po.OzakiPlan)
    jc, pc = jres.c.to_csr(), pres.c.to_csr()
    assert pc.pattern_equal(jc) and np.array_equal(pc.data, jc.data)
    for k in ("num_pairs", "numblkC_candidate", "numblkC", "nnzC",
              "padding_ratio", "slices"):
        assert pres.stats[k] == jres.stats[k], k


def test_auto_f64_router_on_the_arrow_matches_jax():
    rng = np.random.default_rng(2)
    a = _arrow()
    a = a.with_data(rng.standard_normal(a.nnz))
    jc, jres = spgemm_tpu.spgemm_csr(a, tm=32, compute_dtype=np.float64)
    pc, pres = pt.spgemm_csr(to_port(a), tm=32, compute_dtype=torch.float64,
                             device="cpu")
    assert pres.stats["backend"] == jres.stats["backend"] \
        == "ozaki(S=8x8)(xla-fallback)"
    assert pc.pattern_equal(jc)
    np.testing.assert_array_equal(pc.data, jc.data)


@pytest.mark.parametrize("kind", ["integer", "gaussian"])
def test_numeric_and_compact_match_jax(kind):
    a, (ja, jb), (pa, pb) = _tiles(kind, 16, 16)
    jp = jo.build_ozaki_plan(ja, jb)
    plan = po.build_ozaki_plan(pa, pb)
    out, t = po.ozaki_numeric(plan, device="cpu")
    assert set(t) == {"upload_ms", "numeric_ms"}
    jout, _ = jo.ozaki_numeric(jp)
    c = po.ozaki_compact(plan, *out, (a.m, a.n)).to_csr()
    exp = jo.ozaki_compact(jp, *jout, (a.m, a.n)).to_csr()
    assert c.pattern_equal(exp) and np.array_equal(c.data, exp.data)


def test_empty_product_on_the_slab_engine():
    """An arrow A (no windowed plan) times an empty B: both packages take
    the slab engine and return its empty-product record."""
    a = _arrow()
    e = spgemm_tpu.CSR.from_coo([], [], np.zeros(0), a.shape)
    jres = spgemm_tpu.spgemm_ozaki(jtile.csr_to_tiles(a, 32, 128),
                                   jtile.csr_to_tiles(e, 128, 128))
    pres = pt.spgemm_ozaki(pt.csr_to_tiles(to_port(a), 32, 128),
                           pt.csr_to_tiles(to_port(e), 128, 128),
                           device="cpu")
    assert pres.c.nnz == jres.c.nnz == 0
    assert pres.stats == jres.stats
    assert pres.stats["backend"] == "ozaki"


def test_tk_past_the_f32_product_bound_raises():
    """tk * 127^2 must stay below 2^24 (tk <= 1040): past it the f32
    slice products would round, so the plan raises OzakiOverflow (the
    auto router then runs the double-double scan)."""
    rng = np.random.default_rng(1)
    a = pt.CSR.from_coo(rng.integers(0, 1100, 3000),
                        rng.integers(0, 1100, 3000),
                        rng.standard_normal(3000), (1100, 1100))
    with pytest.raises(po.OzakiOverflow, match="tk <= 1040"):
        po.build_ozaki_plan(pt.csr_to_tiles(a, 16, 1056),
                            pt.csr_to_tiles(a, 1056, 1056))
    plan = po.build_ozaki_plan(pt.csr_to_tiles(a, 16, 1040),
                               pt.csr_to_tiles(a, 1040, 1040))
    assert plan.base.tk == 1040


def test_executor_matches_jax_and_updates_values():
    """Port of tests/test_executor.py's OzakiExecutor case: run + assemble
    on the integer model (S = 1), then new Gaussian values on the same
    pattern (S adapts to 8), each bit-equal to the JAX executor."""
    rng = np.random.default_rng(21)
    n = 400
    offs = np.arange(-5, 6)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]

    def both(vals):
        a = spgemm_tpu.CSR.from_coo(r, c, vals, (n, n))
        return ((jtile.csr_to_tiles(a, 16, 128),
                 jtile.csr_to_tiles(a, 128, 128)),
                (pt.csr_to_tiles(to_port(a), 16, 128),
                 pt.csr_to_tiles(to_port(a), 128, 128)))

    (ja, jb), (pa, pb) = both(rng.integers(1, 10, r.size).astype(float))
    jex = JOzakiExecutor(jo.build_ozaki_plan(ja, jb), ja, jb)
    pex = pt.OzakiExecutor(pt.build_ozaki_plan(pa, pb), pa, pb,
                           device="cpu")
    for _ in range(2):  # repeated runs on resident operands
        np.testing.assert_array_equal(
            pex.assemble(pex.run()), jex.assemble(jex.run()))
    assert pex.plan.sa == 1

    (ja2, jb2), (pa2, pb2) = both(rng.standard_normal(r.size))
    jex.update_values(ja2, jb2)
    pex.update_values(pa2, pb2)
    assert pex.plan.sa == jex.plan.sa == 8
    got, exp = pex.run(), jex.run()
    for g, e in zip(got, exp):
        assert torch.equal(g, torch.from_numpy(np.array(e)))
    np.testing.assert_array_equal(pex.assemble(got), jex.assemble(exp))

    other = spgemm_tpu.CSR.from_coo(np.array([0]), np.array([0]),
                                    np.array([1.0]), (n, n))
    with pytest.raises(ValueError, match="same tile structure"):
        pex.update_values(pt.csr_to_tiles(to_port(other), 16, 128),
                          pt.csr_to_tiles(to_port(other), 128, 128))
    with pytest.raises(ValueError, match="same tile structure"):
        jex.update_values(jtile.csr_to_tiles(other, 16, 128),
                          jtile.csr_to_tiles(other, 128, 128))


def test_executor_refuses_other_plans_and_timing_needs_a_card():
    _, _, (pa, pb) = _tiles("gaussian", 16, 16)
    strip_plan = po.build_ozaki_strip(pt.csr_to_tiles(pa.to_csr(), 16, 128),
                                      pt.csr_to_tiles(pa.to_csr(), 128, 128))
    with pytest.raises(TypeError, match="OzakiPlan"):
        pt.OzakiExecutor(strip_plan, pa, pb, device="cpu")
    with pytest.raises(TypeError, match="OzakiPlan"):
        JOzakiExecutor(object(), None, None)
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    ex = pt.OzakiExecutor(po.build_ozaki_plan(pa, pb), pa, pb, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.time_numeric()
    with pytest.raises(RuntimeError, match="CUDA"):
        po.time_ozaki(ex.plan, device="cpu")
