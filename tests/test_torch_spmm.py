"""The port's SpMM/SpMV slice against the JAX package on the CPU: host
planes equal array for array, the plain strip SpMM version against the
Pallas kernels in interpret mode (resident and window form, fed the same
packed arrays), and spmm / spmv / spmm_gather against the JAX entry points,
with the same route picked by both routers.

Tolerances: integer values are exact in f32 and must agree exactly;
Gaussian values are summed in another order by the two packages, so rtol
1e-5 and atol 1e-6*max|Y|; f64 within rtol 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgemm_tpu.models.tile as jtile
import spgemm_tpu.ops.spmm as jspmm
from spgemm_tpu.models.csr import CSR as JCSR
from spgemm_tpu.ops.pallas_kernels import spmm_strip_pallas, spmm_window_pallas

import spgemm_tpu_torch as pt
import spgemm_tpu_torch.ops.spmm as pspmm
from spgemm_tpu_torch.ops import spmm_kernels


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def _empty_rows(rng):
    """200 x 190 with tile rows 2-4 and 9 empty (at tm 8 and 16)."""
    r = rng.integers(0, 200, 900)
    r = r[(r // 16 < 2) | (r // 16 > 4)]
    r = r[(r // 16) != 9]
    c = rng.integers(0, 190, r.size)
    return JCSR.from_coo(r, c, rng.integers(1, 10, r.size).astype(np.float64),
                         (200, 190))


def _matrix(kind: str, rng):
    if kind == "random":
        r = rng.integers(0, 170, 1500)
        c = rng.integers(0, 150, 1500)
        return JCSR.from_coo(r, c, rng.integers(1, 10, 1500).astype(
            np.float64), (170, 150))
    if kind == "empty_rows":
        return _empty_rows(rng)
    return JCSR.from_coo([], [], np.zeros(0), (64, 48))


def _assert_close(got, exp, values):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    if values == "integer":
        np.testing.assert_array_equal(got, exp)
    else:
        scale = float(np.abs(exp).max()) if exp.size else 0.0
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("kind", ["random", "empty_rows", "empty"])
@pytest.mark.parametrize("tm,tn", [(8, 16), (16, 16)])
@pytest.mark.parametrize("block_rows", [2, 64])
def test_block_stats_and_packing_match_jax(kind, tm, tn, block_rows):
    rng = np.random.default_rng(3)
    a = _matrix(kind, rng)
    x = rng.standard_normal((a.n, 5))
    jt, pt_ = jtile.csr_to_tiles(a, tm, tn), pt.csr_to_tiles(to_port(a), tm,
                                                             tn)
    jmax, jmin, jspan = jspmm._spmm_block_stats(jt, block_rows)
    pmax, pmin, pspan = pspmm._spmm_block_stats(pt_, block_rows)
    assert (pmax, pspan) == (jmax, jspan)
    np.testing.assert_array_equal(pmin, jmin)
    for dtype, pdtype in ((jnp.float32, torch.float32),
                          (jnp.float64, torch.float64)):
        j_ops = jspmm._pack_spmm_operands(jt, x, 128, dtype, block_rows)
        p_ops = pspmm._pack_spmm_operands(pt_, x, 128, pdtype, block_rows)
        for name, got, exp in zip(("a_dense", "xb", "aptr", "ak", "arow"),
                                  p_ops.to_device("cpu"), j_ops[:5]):
            assert got.is_contiguous()
            assert got.numpy().dtype == exp.dtype, name
            np.testing.assert_array_equal(got.numpy(), exp, err_msg=name)
        assert p_ops.max_ablock == j_ops[5]


def _skewed(rng, m=300, n=1400):
    """Unstructured rows plus one row of 1,200 nonzeros: longer than the
    gather cap of 512, so it splits into sibling segments."""
    r = np.concatenate([np.zeros(1200, np.int64), rng.integers(1, m, 900)])
    c = np.concatenate([rng.permutation(n)[:1200], rng.integers(0, n, 900)])
    return JCSR.from_coo(r, c, rng.standard_normal(r.size), (m, n))


def test_gather_classes_and_packing_match_jax():
    rng = np.random.default_rng(4)
    a = _skewed(rng)
    assert np.diff(a.indptr).max() > 512
    x = rng.standard_normal((a.n, 40))
    jc = jspmm._spmm_gather_classes(a)
    pc = pspmm._spmm_gather_classes(to_port(a))
    assert [(c, len(s)) for c, s in pc] == [(c, len(s)) for c, s in jc]
    assert all(list(map(tuple, ps)) == list(map(tuple, js))
               for (_, ps), (_, js) in zip(pc, jc))
    for np_dt in (np.float32, np.float64):
        jxb, jcls, jk, jkp = jspmm._pack_spmm_gather(a, x, np_dt)
        pxb, pcls, pk, pkp = pspmm._pack_spmm_gather(to_port(a), x, np_dt)
        assert (pk, pkp) == (jk, jkp) and len(pcls) == len(jcls)
        np.testing.assert_array_equal(pxb, jxb)
        for pa_, ja in zip(pcls, jcls):
            for got, exp in zip(pa_, ja):
                assert got.dtype == exp.dtype
                np.testing.assert_array_equal(got, exp)


def _strip_case(values, tm, tn, seed=6):
    rng = np.random.default_rng(seed)
    a = _matrix("random", rng) if tm == 8 else _empty_rows(rng)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
    x = (rng.integers(-4, 5, (a.n, 70)).astype(np.float64)
         if values == "integer" else rng.standard_normal((a.n, 70)))
    return a, x, jtile.csr_to_tiles(a, tm, tn)


@pytest.mark.parametrize("tm,tn", [(8, 16), (16, 16)])
@pytest.mark.parametrize("form", ["resident", "window"])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_strip_matches_pallas(tm, tn, form, values):
    block_rows = 2
    a, x, jt = _strip_case(values, tm, tn)
    stats = jspmm._spmm_block_stats(jt, block_rows)
    ops = jspmm._pack_spmm_operands(jt, x, 128, jnp.float32, block_rows)
    a_dense, xb, aptr, ak, arow, max_ablock = ops
    kw = dict(gm=jt.gm, max_ablock=max_ablock, block_rows=block_rows,
              interpret=True)
    p_ops = pspmm.SpmmOperands(*ops).to_device("cpu")
    kmin = None
    if form == "window":
        kmin_np = np.clip(stats[1], 0, jt.gn - stats[2]).astype(np.int32)
        exp = spmm_window_pallas(*map(jnp.asarray, ops[:5]),
                                 jnp.asarray(kmin_np), kwin=stats[2], **kw)
        kmin = torch.from_numpy(kmin_np)
        pt_ = pt.csr_to_tiles(to_port(a), tm, tn)
        np.testing.assert_array_equal(
            pspmm._window_kmin(pt_, pspmm._spmm_block_stats(pt_, block_rows)),
            kmin_np)
    else:
        exp = spmm_strip_pallas(*map(jnp.asarray, ops[:5]), **kw)
    assert jt.gm > 4 * block_rows  # many blocks run
    before = (spmm_kernels.spmm_strip.kernel_launches,
              spmm_kernels.spmm_strip.plain_launches)
    got = spmm_kernels.spmm_strip(*p_ops, kmin, gm=jt.gm,
                                  block_rows=block_rows)
    assert (spmm_kernels.spmm_strip.kernel_launches,
            spmm_kernels.spmm_strip.plain_launches) == (before[0],
                                                        before[1] + 1)
    _assert_close(got.numpy(), exp, values)
    np.testing.assert_allclose(got.numpy().reshape(-1, 128)[: a.m, :70],
                               a.to_dense() @ x, rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_bad_operands():
    a, x, jt = _strip_case("integer", 8, 16)
    ops = list(pspmm.SpmmOperands(*jspmm._pack_spmm_operands(
        jt, x, 128, jnp.float32, 2)).to_device("cpu"))
    with pytest.raises(ValueError, match="inconsistent"):
        spmm_kernels.spmm_strip(*ops, gm=jt.gm + 1, block_rows=2)
    with pytest.raises(ValueError, match="inconsistent"):
        spmm_kernels.spmm_strip(*ops, torch.zeros(1, dtype=torch.int32),
                                gm=jt.gm, block_rows=2)
    ops[2] = ops[2].long()
    with pytest.raises(ValueError, match="aptr"):
        spmm_kernels.spmm_strip(*ops, gm=jt.gm, block_rows=2)


def _route_spy(monkeypatch, module, log):
    """Record which route each package's spmm takes."""
    for name in ("spmm_gather", "_spmm_strip", "_spmm_tiles"):
        fn = getattr(module, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            log.append(_name)
            return _fn(*args, **kw)

        monkeypatch.setattr(module, name, spy)


def _both(monkeypatch, a, x, tm, tn, **kw):
    """(port Y, JAX Y, port route, JAX route) for one spmm call."""
    jlog, plog = [], []
    _route_spy(monkeypatch, jspmm, jlog)
    _route_spy(monkeypatch, pspmm, plog)
    jdt = jnp.float64 if kw.get("dtype") == torch.float64 else jnp.float32
    jkw = dict(kw, dtype=jdt)
    exp = np.asarray(jspmm.spmm(jtile.csr_to_tiles(a, tm, tn), x, **jkw))
    got = pspmm.spmm(pt.csr_to_tiles(to_port(a), tm, tn), x, device="cpu",
                     **kw)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    return got.numpy(), exp, plog, jlog


@pytest.mark.parametrize("k", [1, 32, 128])
def test_spmm_matches_jax(monkeypatch, make_random_csr, rng, k):
    a = make_random_csr(100, 130, 0.05)
    x = rng.integers(0, 5, size=(130, k)).astype(np.float64)
    got, exp, plog, jlog = _both(monkeypatch, a, x, 16, 16)
    assert plog == jlog == ["_spmm_strip"]
    assert got.shape == (100, k) and got.dtype == np.float32
    _assert_close(got, exp, "integer")
    xg = rng.standard_normal((130, k))
    got, exp, _, _ = _both(monkeypatch, a, xg, 16, 16)
    _assert_close(got, exp, "gaussian")


def test_spmv_vector_matches_jax(make_random_csr, rng):
    a = make_random_csr(90, 60, 0.08)
    x = rng.integers(0, 5, size=60).astype(np.float64)
    exp = np.asarray(jspmm.spmv(jtile.csr_to_tiles(a, 16, 16), x))
    got = pt.spmv(pt.csr_to_tiles(to_port(a), 16, 16), x, device="cpu")
    assert got.shape == (90,)
    _assert_close(got.numpy(), exp, "integer")
    np.testing.assert_array_equal(got.numpy(), a.to_dense() @ x)


def test_spmm_ragged_edge_f64_matches_jax(monkeypatch, make_random_csr, rng):
    a = make_random_csr(37, 41, 0.15)
    x = rng.standard_normal((41, 8))
    got, exp, plog, jlog = _both(monkeypatch, a, x, 16, 16,
                                 dtype=torch.float64)
    assert plog == jlog == ["_spmm_strip"]
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, exp, rtol=1e-12)
    np.testing.assert_allclose(got, a.to_dense() @ x, rtol=1e-12)


def test_spmm_empty_and_shape_mismatch(make_random_csr):
    a = JCSR.from_coo(np.zeros(0), np.zeros(0), np.zeros(0), (32, 32))
    t = pt.csr_to_tiles(to_port(a), 16, 16)
    y = pt.spmm(t, np.ones((32, 4)), device="cpu")
    np.testing.assert_array_equal(y.numpy(), np.asarray(
        jspmm.spmm(jtile.csr_to_tiles(a, 16, 16), np.ones((32, 4)))))
    assert not y.numpy().any()
    b = to_port(make_random_csr(32, 32, 0.1))
    for x in (np.ones((31, 4)), np.ones(33)):
        with pytest.raises(ValueError, match="shape mismatch"):
            pt.spmm(pt.csr_to_tiles(b, 16, 16), x, device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        pt.spmm(pt.csr_to_tiles(b, 16, 16), np.ones((32, 4)),
                backend="nope", device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forced_xla_matches_jax(monkeypatch, make_random_csr, rng, dtype):
    a = make_random_csr(200, 200, 0.05)
    x = rng.integers(0, 5, size=(200, 16)).astype(np.float64)
    got, exp, plog, jlog = _both(monkeypatch, a, x, 16, 16, backend="xla",
                                 dtype=dtype)
    assert plog == jlog == ["_spmm_tiles"]
    _assert_close(got, exp, "integer")
    # a small chunk runs the loop over stored tiles, as the JAX scan does
    jt = jtile.csr_to_tiles(a, 16, 16)
    xb = np.pad(x, ((0, jt.gn * jt.tn - jt.n), (0, 0))).reshape(jt.gn, 16, 16)
    jy = jspmm._spmm_tiles(jnp.asarray(jt.dense(), dtype=jnp.float32),
                           jnp.asarray(jt.trow), jnp.asarray(jt.tcol),
                           jnp.asarray(xb, dtype=jnp.float32), gm=jt.gm,
                           chunk=8)
    ptile = pt.csr_to_tiles(to_port(a), 16, 16)
    py = pspmm._spmm_tiles(torch.from_numpy(ptile.dense(np.float32)),
                           torch.from_numpy(ptile.trow),
                           torch.from_numpy(ptile.tcol),
                           torch.from_numpy(xb.astype(np.float32)),
                           gm=ptile.gm, chunk=8)
    assert ptile.nt > 8
    _assert_close(py.numpy(), jy, "integer")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_forced_gather_long_rows_match_jax(monkeypatch, dtype):
    rng = np.random.default_rng(9)
    a = _skewed(rng)
    x = rng.standard_normal((a.n, 96))
    got, exp, plog, jlog = _both(monkeypatch, a, x, 16, 16, backend="gather",
                                 dtype=dtype)
    assert plog == jlog == ["spmm_gather"]
    if dtype == torch.float64:
        np.testing.assert_allclose(got, exp, rtol=1e-12, atol=1e-12)
    else:
        _assert_close(got, exp, "gaussian")
    y = pt.spmm_gather(to_port(a), x, dtype=dtype, device="cpu")
    np.testing.assert_allclose(y.numpy(), a.to_dense() @ x, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("case", ["unstructured", "banded"])
def test_auto_route_matches_jax(monkeypatch, case):
    rng = np.random.default_rng(12)
    if case == "unstructured":
        # scattered nonzeros: tile bytes above the 16 MB floor and above
        # the gather bytes, so both routers pick "gather"
        n = 4096
        r, c = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
        a = JCSR.from_coo(r, c, rng.integers(1, 10, r.size).astype(
            np.float64), (n, n))
        route = "spmm_gather"
    else:
        from spgemm_tpu.utils.generators import banded

        a = banded(rng, 1000, 30)
        route = "_spmm_strip"
    x = rng.integers(-3, 4, (a.n, 32)).astype(np.float64)
    t = pt.csr_to_tiles(to_port(a), 16, 128)
    assert (t.nt * 16 * 128 * 4 > 16 << 20) == (case == "unstructured")
    got, exp, plog, jlog = _both(monkeypatch, a, x, 16, 128)
    assert plog == jlog == [route]
    _assert_close(got, exp, "integer")


def test_mode_gate_on_cuda():
    """_spmm_mode's card gate (no card needed: it reads only shapes)."""
    rng = np.random.default_rng(2)
    a = to_port(_matrix("random", rng))
    dev = torch.device("cuda")
    t = pt.csr_to_tiles(a, 16, 16)
    assert pspmm._spmm_mode(t, 128, device=torch.device("cpu"))[0] == \
        "resident"
    assert pspmm._spmm_mode(t, 128, device=dev)[0] == "resident"
    wide = pspmm.L2_BYTES // (t.gn * t.tn * 4) + 128
    assert pspmm._spmm_mode(t, wide - wide % 128, device=dev)[0] == "window"
    assert pspmm._spmm_mode(pt.csr_to_tiles(a, 12, 16), 128,
                            device=dev)[0] == "xla"


def test_timers_need_a_card(make_random_csr):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    a = to_port(make_random_csr(64, 64, 0.1))
    with pytest.raises(RuntimeError, match="CUDA"):
        pspmm.time_spmm(pt.csr_to_tiles(a, 16, 16), np.ones((64, 8)),
                        device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pspmm.time_spmm_gather(a, np.ones((64, 8)), device="cpu")


def test_pack_width():
    widths = {k: spmm_kernels.pack_width(k)
              for k in (1, 3, 8, 9, 16, 17, 32, 33, 128, 129)}
    assert widths == {1: 1, 3: 8, 8: 8, 9: 16, 16: 16, 17: 32, 32: 32,
                      33: 128, 128: 128, 129: 256}


@pytest.mark.parametrize("k", [1, 3, 8, 17, 32])
@pytest.mark.parametrize("form", ["resident", "window"])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_narrow_packing_matches_pallas(k, form, values):
    """X packed at the narrow width holds the reference's 128-wide X's
    first columns, and the plain version at that width gives the Pallas
    kernels' Y (run at k_pad 128) in its first k columns."""
    block_rows = 2
    tm, tn = 16, 16
    a, x, jt = _strip_case(values, tm, tn, seed=40 + k)
    x = x[:, :k]
    width = spmm_kernels.pack_width(k)
    stats = jspmm._spmm_block_stats(jt, block_rows)
    j_ops = jspmm._pack_spmm_operands(jt, x, 128, jnp.float32, block_rows)
    kw = dict(gm=jt.gm, max_ablock=j_ops[5], block_rows=block_rows,
              interpret=True)
    pt_ = pt.csr_to_tiles(to_port(a), tm, tn)
    p_ops = pspmm._pack_spmm_operands(pt_, x, width, torch.float32,
                                      block_rows)
    np.testing.assert_array_equal(p_ops.xb, j_ops[1][..., :width])
    kmin = None
    if form == "window":
        kmin_np = np.clip(stats[1], 0, jt.gn - stats[2]).astype(np.int32)
        exp = spmm_window_pallas(*map(jnp.asarray, j_ops[:5]),
                                 jnp.asarray(kmin_np), kwin=stats[2], **kw)
        kmin = torch.from_numpy(kmin_np)
    else:
        exp = spmm_strip_pallas(*map(jnp.asarray, j_ops[:5]), **kw)
    got = spmm_kernels.spmm_strip(*p_ops.to_device("cpu"), kmin, gm=jt.gm,
                                  block_rows=block_rows)
    assert got.shape[2] == width
    _assert_close(got.numpy()[..., :k], np.asarray(exp)[..., :k], values)
    assert not got.numpy()[..., k:].any()


def _width_spy(monkeypatch, widths):
    """Record the width the port packs X at for the strip kernel."""
    fn = pspmm._pack_spmm_operands

    def spy(a, x, width, *args, **kw):
        widths.append(width)
        return fn(a, x, width, *args, **kw)

    monkeypatch.setattr(pspmm, "_pack_spmm_operands", spy)


@pytest.mark.parametrize("k", [1, 3, 8, 17, 32])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_narrow_spmm_and_spmv_match_jax(monkeypatch, make_random_csr, rng, k,
                                        values):
    a = make_random_csr(120, 140, 0.06)
    if values == "integer":
        x = rng.integers(-4, 5, size=(140, k)).astype(np.float64)
    else:
        a = a.with_data(rng.standard_normal(a.nnz))
        x = rng.standard_normal((140, k))
    widths = []
    _width_spy(monkeypatch, widths)
    got, exp, plog, jlog = _both(monkeypatch, a, x, 16, 16)
    assert plog == jlog == ["_spmm_strip"]
    assert widths == [spmm_kernels.pack_width(k)]
    assert got.shape == (120, k)
    _assert_close(got, exp, values)
    if k == 1:
        v = pt.spmv(pt.csr_to_tiles(to_port(a), 16, 16), x[:, 0],
                    device="cpu")
        jv = np.asarray(jspmm.spmv(jtile.csr_to_tiles(a, 16, 16), x[:, 0]))
        assert v.shape == (120,) and widths[-1] == 1    # SpMV at width 1
        _assert_close(v.numpy(), jv, values)


@pytest.mark.parametrize("k", [1, 3, 8, 17, 32])
@pytest.mark.parametrize("case", ["unstructured", "banded"])
def test_routing_at_narrow_k_matches_jax(monkeypatch, case, k):
    """Routing still decides on the 128-padded width at k <= 32: the gather
    gate's traffic model and the kernel mode are the reference's."""
    rng = np.random.default_rng(50 + k)
    if case == "unstructured":
        n = 4096
        r, c = rng.integers(0, n, 3000), rng.integers(0, n, 3000)
        a = JCSR.from_coo(r, c, rng.integers(1, 10, r.size).astype(
            np.float64), (n, n))
        route = "spmm_gather"
    else:
        from spgemm_tpu.utils.generators import banded

        a = banded(rng, 1000, 30)
        route = "_spmm_strip"
    x = rng.integers(-3, 4, (a.n, k)).astype(np.float64)
    got, exp, plog, jlog = _both(monkeypatch, a, x, 16, 128)
    assert plog == jlog == [route]
    _assert_close(got, exp, "integer")
    t = pt.csr_to_tiles(to_port(a), 16, 128)
    dev = torch.device("cuda")  # the card's gate reads only shapes
    assert pspmm._spmm_mode(t, 128, device=dev)[0] == "resident"
