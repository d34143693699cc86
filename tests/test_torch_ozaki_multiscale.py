"""The auto f64 router's hi/lo passes on multi-scale rows (ops/ozaki.py):
on the SIMP stiffness of top3d's cantilever, whose rows span 76-79 bits,
one Ozaki pass is accurate only against the rows' and columns' maxima;
the split's four passes hold f64 entry by entry. Also the split itself
(exact, within the slice window, the A_lo B_lo term under its bound and
an entry that is that term's alone), the span past which the auto router
leaves the split for the double-double scan, one pass where the span
fits, the device combine's scaling, and the route's spans and byte
counters.

Jax-free but for the one test that holds explicit backend="ozaki" to
the JAX package bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import spgemm_tpu_torch as pt
from perfbench import reference
from perfbench.matrices.top3d import Stiffness
from spgemm_tpu_torch.cli import main as cli_main
from spgemm_tpu_torch.io.mmio import write_mtx
from spgemm_tpu_torch.ops import ozaki as po
from spgemm_tpu_torch.utils.generators import banded

# top3d's cantilever at 12x4x2 elements: 540 free DOFs, 27,846 nnz
SIMP = {"nelx": 12, "nely": 4, "nelz": 2, "nu": 0.3, "penal": 3.0,
        "E0": 1.0, "Emin": 1e-9}
LIMIT = 1e-12          # the benchmark cell's max_scaled_err limit
WINDOW = 56            # bits under a row's scale that 8 slices hold


def _stiffness(seed: int) -> pt.CSR:
    """K(free, free) in float64 from fresh SIMP densities."""
    k = Stiffness(SIMP)
    g = torch.Generator().manual_seed(seed)
    return pt.CSR(k.indptr, k.indices, k.values(g, torch.float64).numpy(),
                  k.shape)


def _scaled_err(c: pt.CSR, a: pt.CSR) -> tuple[int, float]:
    """(pattern mismatches, max |C - A@A| / (|A||A|)_ij) against the plain
    float64 torch reference."""
    ip, idx, val, mag = reference.spgemm(
        a.indptr, a.indices, a.data, a.indptr, a.indices, a.data, a.n,
        device="cpu")
    ref = sp.csr_matrix((val.numpy(), idx.numpy(), ip.numpy()), a.shape)
    got = sp.csr_matrix((c.data, c.indices, c.indptr), a.shape)
    got.sort_indices()
    if not (np.array_equal(got.indptr, ref.indptr)
            and np.array_equal(got.indices, ref.indices)):
        return abs(got.nnz - ref.nnz) or 1, float("inf")
    return 0, float((np.abs(got.data - ref.data) / mag.numpy()).max())


def _tiles(a: pt.CSR):
    return pt.csr_to_tiles(a, 64, 128), pt.csr_to_tiles(a, 128, 128)


@pytest.mark.parametrize("seed", [12345, 2**31 + 7])
def test_simp_auto_f64_holds_f64_entry_by_entry(seed):
    a = _stiffness(seed)
    c, res = pt.spgemm_csr(a, tm=64, tn=128, compute_dtype=torch.float64,
                           device="cpu")
    assert res.stats["backend"] == "ozaki-strip(S=8x8)"
    assert res.stats["ozaki_passes"] == 4
    plan = res.schedule
    assert [p.pmax for p in plan.passes] == [p.sa + p.sb - 2
                                             for p in plan.passes]
    mism, err = _scaled_err(c, a)
    assert mism == 0 and err <= LIMIT, err


def test_explicit_ozaki_keeps_the_jax_contract_and_fails_the_limit():
    """backend="ozaki" (strict=False) is the JAX package's route bit for
    bit, and the auto route's one pass before the split: on SIMP rows its
    error is far past the limit, so the limit can fail."""
    import spgemm_tpu
    from spgemm_tpu.models.csr import CSR as JCSR

    a = _stiffness(12345)
    at, bt = _tiles(a)
    res = pt.spgemm(at, bt, backend="ozaki", device="cpu")
    ja = JCSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)
    jres = spgemm_tpu.spgemm(spgemm_tpu.csr_to_tiles(ja, 64, 128),
                             spgemm_tpu.csr_to_tiles(ja, 128, 128),
                             backend="ozaki")
    assert res.stats["backend"] == jres.stats["backend"]
    assert res.stats["ozaki_passes"] == 1
    got, exp = res.c.to_csr(), jres.c.to_csr()
    assert got.pattern_equal(exp) and np.array_equal(got.data, exp.data)
    mism, err = _scaled_err(got, a)
    assert mism == 0 and err > 1e3 * LIMIT, err


@pytest.mark.parametrize("axis", [0, 1], ids=["A_rows", "B_cols"])
def test_split_is_exact_and_each_part_within_the_window(axis):
    a = _stiffness(12345)
    t = _tiles(a)[axis]
    e, s, bit_span = po._operand_model(t, axis)
    assert bit_span > WINDOW and s == 8          # SIMP rows: 76-79 bits
    hi, lo = po.split_hi_lo(t, e, axis)
    assert np.array_equal(hi + lo, t.val) and lo.any()
    e_hi, _, span_hi = po._operand_model(dataclasses.replace(t, val=hi),
                                         axis)
    assert np.array_equal(e_hi, e) and span_hi <= WINDOW
    _, _, span_lo = po._operand_model(dataclasses.replace(t, val=lo), axis)
    assert span_lo <= WINDOW


def test_left_out_lo_lo_term_is_under_its_bound():
    """Each product of A_lo B_lo, the fourth pass, is at most
    2^(Ea_r + Eb_c - 112), so (|A_lo||B_lo|)_ij is at most that times the
    products the entry sums; on SIMP rows the term is far under the limit
    against (|A||A|)_ij, but not against an entry that is the term's alone
    (test_entry_of_lo_parts_alone)."""
    a = _stiffness(12345)
    at, bt = _tiles(a)
    ea = po._operand_model(at, 0)[0]
    eb = po._operand_model(bt, 1)[0]

    def lo_csr(t, e, axis):
        lo = np.abs(po.split_hi_lo(t, e, axis)[1])
        c = dataclasses.replace(t, val=lo).to_csr()
        return sp.csr_matrix((c.data, c.indices, c.indptr), c.shape)

    la, lb = lo_csr(at, ea, 0), lo_csr(bt, eb, 1)
    lolo = (la @ lb).tocoo()
    ones = lambda x: sp.csr_matrix((np.ones_like(x.data), x.indices,
                                    x.indptr), x.shape)
    n_products = np.asarray((ones(la) @ ones(lb))[lolo.row, lolo.col])
    bound = np.ldexp(n_products.ravel(),
                     ea[lolo.row] + eb[lolo.col] - 2 * WINDOW)
    assert lolo.nnz and np.all(lolo.data <= bound)
    m = sp.csr_matrix((np.abs(a.data), a.indices, a.indptr), a.shape)
    mag = np.asarray((m @ m)[lolo.row, lolo.col]).ravel()
    assert (lolo.data / mag).max() < 1e-3 * LIMIT


def test_split_plan_without_the_native_library(monkeypatch):
    """Without the native library the split takes the NumPy value model
    and the dense-cube slicing: every pass's arrays as the native ones."""
    from spgemm_tpu_torch.utils import native

    at, bt = _tiles(_stiffness(12345))
    want = po.build_ozaki_strip(at, bt, strict=True)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    got = po.build_ozaki_strip(at, bt, strict=True)
    assert len(got.passes) == len(want.passes) == 4
    for p, q in zip(got.passes, want.passes):
        for f in ("av8", "bv8", "ea", "eb"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f), f)
        assert (p.sa, p.sb, p.pmax) == (q.sa, q.sb, q.pmax)


def _lo_alone(a01: float, b10: float):
    """(A, B) tiles, n = 256: A = I with A[0,1] = a01, B = I with B[0,0]
    moved to B[0,3] and B[1,0] = b10, B[2,0] = 1. C[0,0] = a01 b10 sums
    that one product: where a01 is wholly under row 0's 56-bit window and
    b10 under column 0's, it lies in A_lo B_lo alone."""
    n = 256
    d = np.arange(n)
    a = pt.CSR.from_coo(np.r_[d, 0], np.r_[d, 1], np.r_[np.ones(n), a01],
                        (n, n))
    br = np.r_[0, d[1:], 1, 2]
    bc = np.r_[3, d[1:], 0, 0]
    b = pt.CSR.from_coo(br, bc, np.r_[np.ones(n), b10, 1.0], (n, n))
    return pt.csr_to_tiles(a, 32, 128), pt.csr_to_tiles(b, 128, 128)


@pytest.mark.parametrize("engine", ["strip", "slab"])
def test_entry_of_lo_parts_alone(engine, monkeypatch):
    """An entry whose one product has both factors under the window (row
    0 spans 62 bits, column 0 65): without A_lo B_lo it would read 0, a
    scaled error of 1; the fourth pass gives it exactly, on both
    engines."""
    a01, b10 = 1.5 * 2.0 ** -60, 1.25 * 2.0 ** -62
    at, bt = _lo_alone(a01, b10)
    if engine == "slab":
        monkeypatch.setattr(po, "strip_kernel_takes", lambda *args: False)
    res = po.spgemm_ozaki(at, bt, device="cpu", strict=True)
    assert isinstance(res.schedule, po.OzakiStripPlan if engine == "strip"
                      else po.OzakiPlan)
    assert res.stats["ozaki_passes"] == 4
    c = res.c.to_csr()
    row0 = dict(zip(c.indices[c.indptr[0]:c.indptr[1]],
                    c.data[c.indptr[0]:c.indptr[1]]))
    assert row0[0] == a01 * b10 != 0.0
    assert row0[1] == a01 and row0[3] == 1.0


def test_split_span_limit_leaves_for_the_double_double_scan():
    """The strict route splits up to a span of 112 bits, where each lo
    part still fits its slices; one bit-span past it, where the double-
    double scan's planes hold the products, it raises OzakiOverflow for
    the auto router to run that scan. The non-strict route keeps the JAX
    package's rule and runs one pass."""
    at, bt = _lo_alone(2.0 ** -111, 0.75)         # row 0: 112 bits
    assert po._operand_model(at, 0)[2] == 112
    plan = po.build_ozaki_strip(at, bt, strict=True)
    assert [(p.sa, p.sb) for p in plan.passes] == [(8, 1), (1, 1)]
    at, bt = _lo_alone(2.0 ** -112, 0.75)         # row 0: 113 bits
    with pytest.raises(po.OzakiOverflow):
        po.build_ozaki_strip(at, bt, strict=True)
    assert not po.build_ozaki_strip(at, bt).lo_passes


@pytest.mark.parametrize("kind", ["integer", "wide-int"])
def test_one_pass_where_the_span_fits(kind):
    """Data the slices hold whole runs one pass on the strict route, with
    the bits of the non-strict route."""
    rng = np.random.default_rng(4)
    a = banded(rng, 500, 8)
    hi = 10 if kind == "integer" else 2 ** 20
    a = a.with_data(rng.integers(1, hi, a.nnz).astype(np.float64) + 0.5)
    at, bt = pt.csr_to_tiles(a, 32, 128), pt.csr_to_tiles(a, 128, 128)
    strict = po.spgemm_ozaki(at, bt, device="cpu", strict=True)
    plain = po.spgemm_ozaki(at, bt, device="cpu")
    assert strict.stats["ozaki_passes"] == plain.stats["ozaki_passes"] == 1
    assert not strict.schedule.lo_passes
    assert strict.stats["backend"] == plain.stats["backend"]
    got, exp = strict.c.to_csr(), plain.c.to_csr()
    assert got.pattern_equal(exp) and np.array_equal(got.data, exp.data)


def test_device_scaling_equals_ldexp():
    """The combine's (h + m + l) 2^(er + ec - 14) equals the host
    epilogue's np.ldexp wherever the result is a normal number."""
    rng = np.random.default_rng(9)
    h, m, l = (torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(
        np.float32) * 2.0 ** k) for k in (20, -4, -28))
    er = torch.from_numpy(rng.integers(-560, 560, (3, 8)).astype(np.int32))
    ec = torch.from_numpy(rng.integers(-460, 460, (3, 16)).astype(np.int32))
    got = po._scaled_f64(h, m, l, er, ec).numpy()
    v = h.numpy().astype(np.float64) + m.numpy() + l.numpy()
    exp = np.ldexp(v, er.numpy()[:, :, None] + ec.numpy()[:, None, :] - 14)
    assert np.array_equal(got, exp)
    assert np.isfinite(got).all() and (np.abs(got) > 2.0 ** -1022).all()


@pytest.mark.parametrize("route", ["auto", "explicit"])
def test_spans_and_counters_on_the_ozaki_route(route):
    a = _stiffness(7)
    if route == "auto":
        _, res = pt.spgemm_csr(a, tm=64, tn=128, compute_dtype=torch.float64,
                               device="cpu")
    else:
        res = pt.spgemm(*_tiles(a), backend="ozaki", device="cpu")
    tms, st = res.timings_ms, res.stats
    assert {"slice_ms", "download_ms", "upload_ms", "numeric_ms",
            "compact_ms"} <= set(tms)
    assert 0.0 < tms["slice_ms"] <= tms["prep_ms"]
    assert 0.0 <= tms["download_ms"] <= tms["compact_ms"]
    assert st["h2d_bytes"] > 0 and st["d2h_bytes"] > 0
    s = res.schedule.sargs
    slots = s.nt_c * s.tm * s.tn
    if route == "auto":
        # C's entries picked from the passes' f64 plane on the device: a
        # keep flag a candidate tile, rc int32 and the f64 value an entry,
        # the kept tiles' mask words and row pointers; no longer the
        # plane and an occupancy byte a candidate slot
        c = res.c
        picked = (s.nt_c + c.nnz * (4 + 8) + c.nt * s.tm * (s.tn // 32) * 4
                  + c.nt * (s.tm + 1) * 4)
        assert st["d2h_bytes"] == picked < slots * 9
    else:  # one pass: h, m, l, cnt
        assert st["d2h_bytes"] == slots * 16
    assert st["d2h_bytes"] <= 16 * slots
    passes = res.schedule.passes
    int8 = {id(x): x.nbytes for p in passes for x in (p.av8, p.bv8)}
    assert st["h2d_bytes"] > sum(int8.values())


def test_cli_prints_slice_and_passes(tmp_path, capsys):
    p = tmp_path / "k.mtx"
    write_mtx(str(p), _stiffness(3))
    assert cli_main(["-d", "cpu", str(p), "64", "128", "--backend",
                     "ozaki"]) == 0
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("step times:")]
    assert " slice " in line and "slice -" not in line
    assert line.endswith("ozaki passes 1")
