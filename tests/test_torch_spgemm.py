"""The port's orchestrator as a whole against the JAX package on the CPU:
spgemm_csr, spgemm and StripExecutor give the same C, the tiled router
picks the JAX package's route (strip, dense, gustavson, xla) with the
port's own strip gate, the reference's keywords pass through, and the one
route that is not ported (the ESC digit mode) raises NotImplementedError
instead of running something else.

Tolerances as in test_torch_kernels.py: integer values exact, Gaussian
values rtol 1e-5 / atol 1e-6*max|C| (summation order differs).
"""

import numpy as np
import pytest
import torch

import spgemm_tpu
import spgemm_tpu.models.tile as jtile
from spgemm_tpu.ops.executor import StripExecutor as JStripExecutor
from spgemm_tpu.utils.generators import banded as j_banded

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import kernels
from spgemm_tpu_torch.utils.generators import cantlike


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


def _matrix(kind: str, values: str):
    rng = np.random.default_rng(11)
    if kind == "cantlike":
        p = cantlike(700, 64)
        a = spgemm_tpu.CSR(p.indptr, p.indices, p.data, p.shape)
    else:
        a = j_banded(rng, 600, 48)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
    return a


def _assert_same_csr(got, exp, values):
    assert got.pattern_equal(exp)
    if values == "integer":
        np.testing.assert_array_equal(got.data, exp.data)
    else:
        scale = float(np.abs(exp.data).max())
        np.testing.assert_allclose(got.data, exp.data, rtol=1e-5,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("kind", ["cantlike", "banded"])
@pytest.mark.parametrize("aat", [False, True])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_spgemm_csr_matches_jax_strip(kind, aat, values):
    a = _matrix(kind, values)
    jc, jres = spgemm_tpu.spgemm_csr(a, aat=aat, backend="strip")
    before = kernels.strip_numeric.plain_launches
    pc, pres = pt.spgemm_csr(to_port(a), aat=aat, device="cpu")
    assert kernels.strip_numeric.plain_launches == before + 1
    assert pres.stats["backend"] == "strip"
    _assert_same_csr(pc, jc, values)
    for k in ("num_pairs", "numblkC_candidate", "numblkC", "nnzC", "nnzCub"):
        assert pres.stats[k] == jres.stats[k], k


def test_spgemm_tiles_64x128_matches_jax():
    a = _matrix("cantlike", "integer")
    jres = spgemm_tpu.spgemm(jtile.csr_to_tiles(a, 64, 128),
                             jtile.csr_to_tiles(a, 128, 128), backend="strip")
    pa = to_port(a)
    pres = pt.spgemm(pt.csr_to_tiles(pa, 64, 128), pt.csr_to_tiles(pa, 128, 128),
                     device="cpu")
    _assert_same_csr(pres.c.to_csr(), jres.c.to_csr(), "integer")


def _arrow_coo(n: int = 4096):
    """One dense tile-row spanning every k: no windowed strip plan."""
    r = np.concatenate([np.zeros(n // 8, np.int64), np.arange(n)])
    c = np.concatenate([np.arange(0, n, 8), np.arange(n)])
    return r, c, np.full(r.size, 1.5), (n, n)


def _arrow_tiles():
    a = pt.CSR.from_coo(*_arrow_coo())
    return pt.csr_to_tiles(a, 32, 128), pt.csr_to_tiles(a, 128, 128)


def _arrow_tiles_jax():
    a = spgemm_tpu.CSR.from_coo(*_arrow_coo())
    return jtile.csr_to_tiles(a, 32, 128), jtile.csr_to_tiles(a, 128, 128)


@pytest.mark.parametrize("call,jcall", [
    (lambda a: pt.spgemm_esc(a, a, mode="digit", device="cpu"),
     lambda a: spgemm_tpu.spgemm_esc(a, a, mode="digit")),
])
def test_unported_routes_raise(make_random_csr, call, jcall):
    # the last route that raised (the ESC digit mode) now runs: C equal
    # to the JAX package's (integer values: exact in f32)
    ja = make_random_csr(64, 64, 0.1)
    c, _, _ = call(to_port(ja))
    jc, _, _ = jcall(ja)
    assert c.pattern_equal(jc)
    np.testing.assert_array_equal(c.data, jc.data)


def _former_refusals(a):
    """The calls that raised NotImplementedError before the gustavson,
    dense and slab routes were ported: (port result, JAX result, f64)."""
    ja = a
    pa = to_port(a)
    jarrow = _arrow_tiles_jax()
    return {
        "gustavson": lambda: (
            pt.spgemm_csr(pa, backend="gustavson", device="cpu")[0],
            spgemm_tpu.spgemm_csr(ja, backend="gustavson")[0], False),
        "f64-strip": lambda: (
            pt.spgemm_csr(pa.with_data(pa.data + 0.5),
                          compute_dtype=torch.float64, backend="strip",
                          device="cpu")[0],
            spgemm_tpu.spgemm_csr(ja.with_data(ja.data + 0.5),
                                  compute_dtype=np.float64,
                                  backend="strip")[0], True),
        "arrow-ozaki": lambda: (
            pt.spgemm(*_arrow_tiles(), backend="ozaki", device="cpu")
            .c.to_csr(),
            spgemm_tpu.spgemm(*jarrow, backend="ozaki").c.to_csr(), True),
        "dense": lambda: (
            pt.spgemm(pt.csr_to_tiles(pa, 8, 16), pt.csr_to_tiles(pa, 16, 16),
                      backend="dense", device="cpu").c.to_csr(),
            spgemm_tpu.spgemm(jtile.csr_to_tiles(ja, 8, 16),
                              jtile.csr_to_tiles(ja, 16, 16),
                              backend="dense").c.to_csr(), False),
    }


@pytest.mark.parametrize("case", ["gustavson", "f64-strip", "arrow-ozaki",
                                  "dense"])
def test_former_refusals_now_run(make_random_csr, case):
    got, exp, f64 = _former_refusals(make_random_csr(64, 64, 0.1))[case]()
    assert got.pattern_equal(exp)
    if f64:
        np.testing.assert_allclose(got.data, exp.data, rtol=1e-12,
                                   atol=1e-13 * np.abs(exp.data).max())
    else:
        np.testing.assert_array_equal(got.data, exp.data)


def _router_tiles(tm, tn, n=300):
    a = cantlike(n, 16)
    return pt.csr_to_tiles(a, tm, tn), pt.csr_to_tiles(a, tn, tn)


CPU, CUDA = torch.device("cpu"), torch.device("cuda")


@pytest.mark.parametrize("tiles,dtype,device,backend,expected", [
    # the CPU's plain strip version takes any f32 tiles
    ((16, 128), torch.float32, CPU, "auto", ("strip", "")),
    ((16, 16), torch.float32, CPU, "auto", ("strip", "")),
    # CUDA: only the strip kernel's instantiations
    ((16, 128), torch.float32, CUDA, "auto", ("strip", "")),
    ((64, 128), torch.float32, CUDA, "strip", ("strip", "")),
    ((16, 16), torch.float32, CUDA, "auto", ("dense", "")),
    ((8, 16), torch.float32, CUDA, "strip",
     ("dense", "strip-fallback: no strip kernel for 8x16 tiles with tk 16")),
    # f64: no strip and no dense route: the slab route
    ((16, 128), torch.float64, CPU, "auto", ("gustavson", "")),
    ((16, 128), torch.float64, CUDA, "strip",
     ("gustavson", "strip-fallback: float64")),
    ((16, 16), torch.float64, CUDA, "auto", ("gustavson", "")),
    ((16, 16), torch.float32, CUDA, "gustavson", ("gustavson", "")),
    ((16, 16), torch.float32, CPU, "dense", ("dense", "")),
])
def test_router_table(tiles, dtype, device, backend, expected):
    from spgemm_tpu_torch.ops.spgemm import _resolve_backend

    at, bt = _router_tiles(*tiles)
    assert _resolve_backend(at, bt, backend, dtype, device) == expected


def test_router_byte_budgets(monkeypatch):
    """Past the dense budget the router takes the slab route, past the
    slab budget the pair gather ("xla"), with the JAX package's notes."""
    from spgemm_tpu_torch.ops import spgemm as ps

    at, bt = _router_tiles(16, 16)
    monkeypatch.setattr(ps, "DENSE_BYTES", 0)
    assert ps._resolve_backend(at, bt, "auto", torch.float32, CUDA) == \
        ("gustavson", "")
    monkeypatch.setattr(ps, "SLAB_BYTES", 0)
    assert ps._resolve_backend(at, bt, "auto", torch.float32, CUDA) == \
        ("xla", "")
    assert ps._resolve_backend(at, bt, "gustavson", torch.float32, CPU) == \
        ("xla", "gustavson-fallback: pair products exceed HBM budget")
    res = pt.spgemm(at, bt, backend="gustavson", device="cpu")
    assert res.stats["backend"] == \
        "xla(gustavson-fallback: pair products exceed HBM budget)"


def test_router_agrees_with_jax_on_the_cpu():
    """On the CPU both packages take the strip route for f32 at any
    tiles, gustavson when asked for."""
    a = _matrix("cantlike", "integer")
    for tm, tn in ((16, 16), (16, 128)):
        jat, jbt = jtile.csr_to_tiles(a, tm, tn), jtile.csr_to_tiles(a, tn, tn)
        pat_, pbt = pt.csr_to_tiles(to_port(a), tm, tn), pt.csr_to_tiles(
            to_port(a), tn, tn)
        for backend in ("auto", "gustavson"):
            jres = spgemm_tpu.spgemm(jat, jbt, backend=backend)
            pres = pt.spgemm(pat_, pbt, backend=backend, device="cpu")
            assert pres.stats["backend"] == jres.stats["backend"]
            _assert_same_csr(pres.c.to_csr(), jres.c.to_csr(), "integer")


def test_dense_backend_structural_zeros():
    """Port of the JAX package's case: cancellation keeps the entry."""
    a = pt.CSR.from_coo([0, 0], [0, 1], [1.0, -1.0], (2, 2))
    b = pt.CSR.from_coo([0, 1], [0, 0], [1.0, 1.0], (2, 2))
    res = pt.spgemm(pt.csr_to_tiles(a, 2, 2), pt.csr_to_tiles(b, 2, 2),
                    backend="dense", device="cpu")
    c = res.c.to_csr()
    assert c.nnz == 1 and c.data[0] == 0.0


@pytest.mark.parametrize("backend", ["strip", "gustavson", "dense", "xla"])
def test_stored_zero_inputs_are_structural(backend):
    """Port of the JAX package's case: a stored zero is a structural
    nonzero on every backend."""
    a = pt.CSR.from_coo([0, 1], [0, 0], [0.0, 2.0], (2, 2))
    b = pt.CSR.from_coo([0], [0], [3.0], (2, 2))
    res = pt.spgemm(pt.csr_to_tiles(a, 2, 2), pt.csr_to_tiles(b, 2, 2),
                    backend=backend, device="cpu")
    c = res.c.to_csr()
    assert c.nnz == 2, backend
    np.testing.assert_array_equal(c.data, [0.0, 6.0])


@pytest.mark.parametrize("backend", ["gustavson", "dense", "xla"])
def test_acc_dtype_matches_jax(backend):
    """acc_dtype=float64 on f32 operands: the torch-op routes accumulate
    f64 products, as the JAX package's preferred_element_type."""
    a = _matrix("banded", "gaussian")
    jat, jbt = jtile.csr_to_tiles(a, 16, 16), jtile.csr_to_tiles(a, 16, 16)
    pat_, pbt = pt.csr_to_tiles(to_port(a), 16, 16), pt.csr_to_tiles(
        to_port(a), 16, 16)
    jres = spgemm_tpu.spgemm(jat, jbt, backend=backend,
                             acc_dtype=np.float64)
    pres = pt.spgemm(pat_, pbt, backend=backend, acc_dtype=torch.float64,
                     device="cpu")
    got, exp = pres.c.to_csr(), jres.c.to_csr()
    assert got.pattern_equal(exp)
    np.testing.assert_allclose(got.data, exp.data, rtol=1e-12,
                               atol=1e-13 * np.abs(exp.data).max())
    f32 = pt.spgemm(pat_, pbt, backend=backend, device="cpu").c.to_csr()
    assert not np.array_equal(f32.data, got.data)


@pytest.mark.parametrize("backend", ["strip", "pallas"])
def test_acc_dtype_on_a_kernel_raises(backend):
    a = to_port(_matrix("banded", "integer"))
    at, bt = pt.csr_to_tiles(a, 16, 128), pt.csr_to_tiles(a, 128, 128)
    kernel = "strip" if backend == "strip" else "pair"
    with pytest.raises(ValueError, match=f"the {kernel} kernel"):
        pt.spgemm(at, bt, backend=backend, acc_dtype=torch.float64,
                  device="cpu")
    pt.spgemm(at, bt, backend=backend, acc_dtype=torch.float32, device="cpu")


def test_chunk_and_sync_pass_through():
    """A call written for the JAX package runs: chunk reaches the xla
    pair backend (any chunk gives the same C), sync=False skips only
    the final synchronize."""
    a = _matrix("cantlike", "integer")
    jc, _ = spgemm_tpu.spgemm_csr(a, backend="xla", chunk=7, sync=True)
    for kw in (dict(chunk=7), dict(chunk=7, sync=False), dict(sync=False)):
        pc, res = pt.spgemm_csr(to_port(a), backend="xla", device="cpu",
                                **kw)
        _assert_same_csr(pc, jc, "integer")
    for backend in ("gustavson", "dense", "ozaki", "strip"):
        pc, _ = pt.spgemm_csr(to_port(a), backend=backend, sync=False,
                              device="cpu")
        _assert_same_csr(pc, jc, "integer")


def test_auto_route_to_esc_raises_instead_of_running_strip(make_random_csr):
    a = to_port(make_random_csr(256, 256, 0.01))  # unstructured: ESC route
    before = kernels.strip_numeric.plain_launches
    c, res = pt.spgemm_csr(a, device="cpu")
    # the ESC route runs now: the strip route is not taken in its place
    assert res.stats["backend"] == "esc" and res.c is None
    assert kernels.strip_numeric.plain_launches == before
    c2, res = pt.spgemm_csr(a, backend="strip", device="cpu")
    assert res.stats["backend"] == "strip"
    assert c2.pattern_equal(c) and np.array_equal(c2.data, c.data)


def test_unknown_backend_and_device(make_random_csr):
    a = to_port(make_random_csr(32, 32, 0.1))
    with pytest.raises(ValueError, match="unknown backend"):
        pt.spgemm_csr(a, backend="nope", device="cpu")
    if not torch.cuda.is_available():
        # device=None means CUDA: no silent CPU fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.spgemm_csr(a, backend="strip")


def test_executor_run_compact_matches_jax():
    a = _matrix("banded", "gaussian")
    jat, jbt = jtile.csr_to_tiles(a, 16, 128), jtile.csr_to_tiles(a, 128, 128)
    jex = JStripExecutor(jat, jbt, block_rows=4)
    pa = to_port(a)
    pex = pt.StripExecutor(pt.csr_to_tiles(pa, 16, 128),
                           pt.csr_to_tiles(pa, 128, 128), block_rows=4,
                           device="cpu")
    exp = jex.run_compact().to_csr()
    for _ in range(2):  # repeated runs on resident operands
        _assert_same_csr(pex.run_compact().to_csr(), exp, "gaussian")


def test_update_values_behaves_as_jax(make_random_csr, rng):
    a = make_random_csr(96, 96, 0.08)
    jex = JStripExecutor(jtile.csr_to_tiles(a, 8, 16),
                         jtile.csr_to_tiles(a, 16, 16), block_rows=4)
    pa = to_port(a)
    pex = pt.StripExecutor(pt.csr_to_tiles(pa, 8, 16),
                           pt.csr_to_tiles(pa, 16, 16), block_rows=4,
                           device="cpu")
    new = rng.integers(1, 9, a.nnz).astype(np.float64)
    jex.update_values(jtile.csr_to_tiles(a.with_data(new), 8, 16))
    pex.update_values(pt.csr_to_tiles(pa.with_data(new), 8, 16))
    # B keeps the old values in both: C = A_new @ A_old
    _assert_same_csr(pex.run_compact().to_csr(), jex.run_compact().to_csr(),
                     "integer")

    other = make_random_csr(96, 96, 0.2)
    with pytest.raises(ValueError, match="same tile structure"):
        jex.update_values(jtile.csr_to_tiles(other, 8, 16))
    with pytest.raises(ValueError, match="same tile structure"):
        pex.update_values(pt.csr_to_tiles(to_port(other), 8, 16))

    wrapped = pt.StripExecutor.from_args(pex.args, device="cpu",
                                         shape=(96, 96))
    _assert_same_csr(wrapped.run_compact().to_csr(),
                     pex.run_compact().to_csr(), "integer")
    with pytest.raises(ValueError, match="from_args"):
        wrapped.update_values(pt.csr_to_tiles(pa, 8, 16))


def test_time_numeric_needs_a_card(make_random_csr):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card path")
    a = to_port(make_random_csr(64, 64, 0.1))
    ex = pt.StripExecutor(pt.csr_to_tiles(a, 8, 16), pt.csr_to_tiles(a, 16, 16),
                          device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ex.time_numeric()


def test_rectangular_product_matches_jax(make_random_csr):
    a = make_random_csr(100, 70, 0.06)
    b = make_random_csr(70, 120, 0.06)
    jc, _ = spgemm_tpu.spgemm_csr(a, b, backend="strip", tm=16, tn=16)
    pc, _ = pt.spgemm_csr(to_port(a), to_port(b), backend="strip", tm=16,
                          tn=16, device="cpu")
    _assert_same_csr(pc, jc, "integer")


def test_cancellation_keeps_structural_zero():
    a = pt.CSR.from_dense(np.array([[1.0, -1.0], [0.0, 2.0]]))
    b = pt.CSR.from_dense(np.array([[1.0, 0.0], [1.0, 0.0]]))
    c, _ = pt.spgemm_csr(a, b, tm=2, tn=2, backend="strip", device="cpu")
    np.testing.assert_array_equal(c.indptr, [0, 1, 2])
    np.testing.assert_array_equal(c.indices, [0, 0])
    np.testing.assert_array_equal(c.data, [0.0, 2.0])


def test_empty_product_with_packed_occupancy():
    # tn=128 takes the bit-packed compaction path with zero C tiles
    a = pt.CSR.from_coo([], [], np.zeros(0), (50, 50))
    c, res = pt.spgemm_csr(a, tm=16, tn=128, backend="strip", device="cpu")
    assert c.nnz == 0 and res.stats["numblkC"] == 0
