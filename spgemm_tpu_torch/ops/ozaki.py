"""Ozaki-slice f64 SpGEMM for structured patterns: the fused strip route
and the slab engine (port of `spgemm_tpu/ops/ozaki.py`).

Each f64 value is split into S signed 7-bit integer slices against a
per-row (A) or per-column (B) power-of-two scale,

    a[r, k] = 2^(Ea_r - 7) * sum_s qa_s[r, k] * 2^(-7 s)
    b[k, c] = 2^(Eb_c - 7) * sum_t qb_t[k, c] * 2^(-7 t),

with |q| <= 127, so every slice-pair product is an exact int8 x int8 ->
int32 product. The kernel (ops/ozaki_kernels.py, csrc/ozaki_strip.cu)
sums them into int32 pair groups p = s + t, reduces the groups to a
triple float (h, m, l) per C element, and the host applies the
2^(Ea_r + Eb_c - 14) scales in f64 on the kept nonzeros only. S adapts
to the data: small integers need S = 1, general doubles S = 8.

The plans are the JAX package's, array for array: the same scales, spans
and slices (the shared native passes in native/csr2tile.cpp, with the
dense-cube NumPy path as the fallback), the same windowed strip geometry
(ops/gustavson.py:build_strip_args) and the same av8/bv8 layouts.

The slab engine (`OzakiPlan`, `ozaki_core`) runs the same arithmetic as
torch ops on the Gustavson slab plan: per pair group, each slice-pair
slab product as an f32 `bmm` of the int8 planes widened to f32 (exact:
every partial sum is at most tk * 127^2 < 2^24, gated at tk <= 1040),
cast to int32 and summed, one int32 `index_add_` into the C tiles, and
the triple-float TwoSum combine as eager elementwise ops. `spgemm_ozaki`
takes it where the strip kernel cannot run: a pattern with no windowed
strip plan (an arrow), or, on CUDA, tiles the kernel has no
instantiation for (TileSpGEMM's 16x16 among them). What differs from the
JAX package:

* the TPU kernel's VMEM budget loop over block_rows is gone: the strip
  plan takes block_rows=32 unless the caller passes one;
* the JAX package retries on the slab engine after any strip-route
  ValueError but OzakiOverflow; the port decides before any launch, on
  the two causes above. Non-finite values and operands that do not chain
  raise ValueError in both engines, so the caller sees the same result;
* the TPU A/B knobs (SPGEMM_OZAKI_KERNEL, SPGEMM_OZAKI_PMAX,
  SPGEMM_OZAKI_COMBINE) are not carried; the production default runs.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from spgemm_tpu_torch.models.csr import INDEX_DTYPE
from spgemm_tpu_torch.models.tile import TileMat, _build_tilemat, cdiv
from spgemm_tpu_torch.ops import ozaki_kernels
from spgemm_tpu_torch.ops.esc import _sync
from spgemm_tpu_torch.ops.gustavson import (GustavsonPlan, StripArgs,
                                            WindowInfeasible, _u16_to_bf16,
                                            build_gustavson_plan, full_fp32,
                                            to_pairs)
from spgemm_tpu_torch.ops.ozaki_kernels import MAX_SLICES
from spgemm_tpu_torch.utils.timing import cuda_event_ms, resolve_device

_INT32_HEADROOM = 2     # require bound * HEADROOM < 2^31
# the slab engine's f32 slice products are exact while one product's sum,
# at most tk * 127^2, stays below 2^24
_F32_EXACT = 2 ** 24


class OzakiOverflow(ValueError):
    """The int32 accumulation bound cannot be guaranteed for this
    problem (too many products per C element for the slice width), or
    the data's span calls for per-product accuracy. The auto router then
    runs the double-double scan route."""


# --- host-side value model --------------------------------------------------

def _span_slices(dense: np.ndarray, exp_of: np.ndarray) -> tuple[int, int]:
    """(S, raw bit span): S = min(MAX_SLICES, ceil(span / 7)); the bit
    span of value v in a group with scale exponent E is
    E - lsb_exponent(v)."""
    nz = dense != 0.0
    if not nz.any():
        return 1, 0
    v = dense[nz]
    e_scale = exp_of[nz]
    mant, e = np.frexp(v)
    mi = np.abs(np.ldexp(mant, 53)).astype(np.int64)
    tz = np.zeros(mi.shape, np.int64)
    m = mi.copy()
    for step in (32, 16, 8, 4, 2, 1):
        z = (m & ((1 << step) - 1)) == 0
        tz[z] += step
        m[z] >>= step
    lsb = e.astype(np.int64) - 53 + tz
    span = int((e_scale - lsb).max())
    return min(MAX_SLICES, max(1, -(-span // 7))), span


def _slice_int8(dense: np.ndarray, exp_of: np.ndarray, s: int) -> np.ndarray:
    """(S, *dense.shape) int8 slices: x0 = v * 2^(7 - E); q_i = trunc;
    x_{i+1} = (x_i - q_i) * 128. All steps are exact in f64."""
    x = np.ldexp(dense, 7 - exp_of)
    out = np.empty((s,) + dense.shape, np.int8)
    for i in range(s):
        q = np.trunc(x)
        out[i] = q.astype(np.int8)
        if i + 1 < s:
            x = (x - q) * 128.0
    return out


def _check_int32_bound(max_pairs: int, tk: int, sa: int, sb: int) -> None:
    """Per-C-element, per-pair-group int32 accumulation bound: at most
    max_pairs * tk * min(Sa, Sb) products of magnitude <= 127^2."""
    bound = max_pairs * tk * min(sa, sb) * 127 * 127
    if bound * _INT32_HEADROOM >= 2 ** 31:
        raise OzakiOverflow(
            f"int32 bound {bound:.3g} (pairs/tile={max_pairs}, tk={tk}, "
            f"g={min(sa, sb)}) too close to 2^31: use the double-double "
            "scan route for this problem")


def _check_f32_products(tk: int) -> None:
    """The slab engine multiplies int8 slices as f32: exact only while
    tk * 127^2 < 2^24, i.e. tk <= 1040."""
    if tk * 127 * 127 >= _F32_EXACT:
        raise OzakiOverflow(
            f"tk={tk}: one int8 slice product sums up to tk*127^2 = "
            f"{tk * 127 * 127} >= 2^24, past what the slab engine's f32 "
            "products hold exactly (tk <= 1040); use the double-double "
            "scan route")


def _exponents(absmax: np.ndarray) -> np.ndarray:
    """frexp exponents of the per-row/column maxima (0 where empty): every
    |v| of the row/column is then < 2^E."""
    _, e = np.frexp(absmax)
    e[absmax == 0.0] = 0
    return e.astype(np.int64)


def _scales_and_slices_prep(a: TileMat, b: TileMat, *,
                            strict: bool = False):
    """Dense-cube value model (the fallback without the native library):
    per-row/per-column pow2 scales, adaptive slice counts and the strict
    extreme-span routing check. Returns (ad, bd, ea, eb, sa, sb, span)."""
    tm, tn = a.tm, b.tn
    ad = a.dense(np.float64)
    bd = b.dense(np.float64)
    if not (np.isfinite(ad).all() and np.isfinite(bd).all()):
        raise ValueError("ozaki engine requires finite values")

    a_rowmax = np.abs(ad).max(axis=2)                       # (nt_a, tm)
    ea = np.zeros(a.gm * tm, np.float64)
    np.maximum.at(ea.reshape(a.gm, tm), a.trow.astype(np.int64), a_rowmax)
    ea = _exponents(ea)                                     # (gm*tm,)

    b_colmax = np.abs(bd).max(axis=1)                       # (nt_b, tn)
    eb = np.zeros(b.gn * tn, np.float64)
    np.maximum.at(eb.reshape(b.gn, tn), b.tcol.astype(np.int64), b_colmax)
    eb = _exponents(eb)                                     # (gn*tn,)

    exp_a = ea.reshape(a.gm, tm)[a.trow.astype(np.int64)][:, :, None]
    exp_b = eb.reshape(b.gn, tn)[b.tcol.astype(np.int64)][:, None, :]
    sa, span_a = _span_slices(ad, np.broadcast_to(exp_a, ad.shape))
    sb, span_b = _span_slices(bd, np.broadcast_to(exp_b, bd.shape))
    # Beyond the 56-bit slice window the capped slicing is the blocked
    # Ozaki error model; only extreme multi-scale rows (spread beyond
    # ~2^64) get whole entries truncated, and the auto router (strict)
    # prefers the double-double scan there when its f32 planes can hold
    # the products.
    if strict and max(span_a, span_b) > 7 * MAX_SLICES + 64:
        nza = np.abs(ad[ad != 0.0])
        nzb = np.abs(bd[bd != 0.0])
        pmax = (float(nza.max()) * float(nzb.max())
                if nza.size and nzb.size else 0.0)
        pmin = (float(nza.min()) * float(nzb.min())
                if nza.size and nzb.size else 0.0)
        _extreme_span_check(max(span_a, span_b), pmax, pmin)
    return ad, bd, ea, eb, sa, sb, max(span_a, span_b)


def _extreme_span_check(span: int, pmax: float, pmin: float) -> None:
    """strict=True routing: prefer the DD scan for extreme multi-scale
    data when the DD planes can represent the products."""
    dd_viable = (pmax < 2.0 ** 120) and (pmin == 0.0
                                         or pmin > 2.0 ** -120)
    if dd_viable:
        raise OzakiOverflow(
            f"per-row/col significand span {span} bits is far beyond "
            f"the {7 * MAX_SLICES}-bit slice window (extreme "
            "multi-scale data); routing prefers the double-double scan")


def _scales_spans_native(a: TileMat, b: TileMat, *, strict: bool = False):
    """Native tile-CSR value model: the scales, slice counts and strict
    check of _scales_and_slices_prep in three O(nnz) passes, without the
    dense f64 cubes. Returns (ea, eb, sa, sb, span), or None without the
    native library."""
    from spgemm_tpu_torch.utils.native import (ozaki_scales_native,
                                               ozaki_span_native)

    ma = ozaki_scales_native(a, 0)
    if ma is None:
        return None
    mb = ozaki_scales_native(b, 1)
    if not (np.isfinite(a.val).all() and np.isfinite(b.val).all()):
        raise ValueError("ozaki engine requires finite values")
    ea = _exponents(ma)
    eb = _exponents(mb)
    span_a, amax_a, amin_a = ozaki_span_native(a, 0, ea)
    span_b, amax_b, amin_b = ozaki_span_native(b, 1, eb)
    sa = min(MAX_SLICES, max(1, -(-span_a // 7)))
    sb = min(MAX_SLICES, max(1, -(-span_b // 7)))
    span = max(span_a, span_b)
    if strict and span > 7 * MAX_SLICES + 64:
        both = amax_a > 0.0 and amax_b > 0.0
        _extreme_span_check(span,
                            amax_a * amax_b if both else 0.0,
                            amin_a * amin_b if both else 0.0)
    return ea, eb, sa, sb, span


# --- fused strip route: plan ---------------------------------------------------

@dataclasses.dataclass
class OzakiStripPlan:
    """Plan of the fused Ozaki strip kernel: the windowed strip geometry
    carrying int8 slice stacks instead of f32 value planes."""

    sargs: StripArgs             # geometry, occupancy planes, slot tables
    av8: np.ndarray              # (ntA_pad, stack_rows, tk) int8
    bv8: np.ndarray              # (gk_pad, tk, sb*max_b*tn) int8, t-major cols
    ea: np.ndarray               # (gm*tm,) per-row scale exponents
    eb: np.ndarray               # (gn*tn,) per-col scale exponents
    sa: int
    sb: int
    pmax: int = MAX_SLICES * 2 - 2   # pair-group truncation (see build)
    prep_ms: float = 0.0
    symbolic_ms: float = 0.0

    @property
    def stack_rows(self) -> int:
        return self.av8.shape[1]

    @classmethod
    def from_numpy(cls, fields: dict) -> "OzakiStripPlan":
        """Port plan from the JAX package's OzakiStripPlan fields given as
        NumPy arrays (e.g. {f.name: getattr(plan, f.name)} of a
        spgemm_tpu plan); `sargs`, the JAX StripArgs, goes through
        StripArgs.from_numpy."""
        sargs = fields["sargs"]
        names = {f.name for f in dataclasses.fields(cls)} - {"sargs"}
        kw = {k: v for k, v in fields.items() if k in names}
        return cls(sargs=StripArgs.from_numpy(
            {f.name: getattr(sargs, f.name)
             for f in dataclasses.fields(sargs)}), **kw)

    def kernel_kwargs(self) -> dict:
        s = self.sargs
        return dict(gm=s.gm, max_b=s.max_b, max_cblock=s.max_cblock,
                    block_rows=s.block_rows, sa=self.sa, sb=self.sb,
                    pmax=self.pmax)

    def to_device(self, device) -> tuple[torch.Tensor, ...]:
        """(av8, a_occ, bv8, b_occ, aptr, ak, slots) on `device`, in the
        argument order of ops/ozaki_kernels.py:ozaki_strip_numeric."""
        s = self.sargs
        host = (torch.from_numpy(np.ascontiguousarray(self.av8)),
                _u16_to_bf16(s.a_occ),
                torch.from_numpy(np.ascontiguousarray(self.bv8)),
                _u16_to_bf16(s.b_occ),
                torch.from_numpy(np.ascontiguousarray(s.aptr, np.int32)),
                torch.from_numpy(np.ascontiguousarray(s.ak, np.int32)),
                torch.from_numpy(np.ascontiguousarray(s.slots, np.int32)))
        return tuple(t.to(device) for t in host)


def _max_pairs_per_ctile(a: TileMat, b: TileMat) -> int:
    """Max (A tile, B tile) pair count over C tiles: the int32 bound's
    multiplicity term."""
    acsc_ptr, acsc_perm = a.csc_view()
    bptr = b.tptr.astype(np.int64)
    cnt_a = np.diff(acsc_ptr).astype(np.int64)
    cnt_b = np.diff(bptr)
    pairs_per_k = cnt_a * cnt_b
    total = int(pairs_per_k.sum())
    if total == 0:
        return 1
    kk = np.repeat(np.arange(a.gn, dtype=np.int64), pairs_per_k)
    off = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(pairs_per_k) - pairs_per_k, pairs_per_k)
    x = off // cnt_b[kk]
    y = off % cnt_b[kk]
    ia = acsc_perm[acsc_ptr[kk].astype(np.int64) + x]
    ckey = a.trow[ia].astype(np.int64) * b.gn + b.tcol[bptr[kk] + y]
    _, cnts = np.unique(ckey, return_counts=True)
    return int(cnts.max())


def build_ozaki_strip(a: TileMat, b: TileMat, *,
                      strict: bool = False,
                      block_rows: int | None = None) -> OzakiStripPlan:
    """Build the fused-kernel plan. Raises OzakiOverflow when the int32
    bound or the strict extreme-span check fails (the auto router then
    runs the double-double scan), WindowInfeasible when the windowed strip
    geometry is infeasible (spgemm_ozaki then runs the slab engine),
    ValueError on mismatched operands or non-finite values."""
    from spgemm_tpu_torch.ops.gustavson import build_strip_args
    from spgemm_tpu_torch.utils.native import (ozaki_slice_a_native,
                                               ozaki_slice_b_native)

    if a.n != b.m or a.tn != b.tm:
        raise ValueError(f"operands do not chain: A {a.shape} in {a.tm}x"
                         f"{a.tn} tiles, B {b.shape} in {b.tm}x{b.tn} tiles")
    t0 = time.perf_counter()
    dense_bytes = (a.nt * a.tm * a.tn + b.nt * b.tm * b.tn) * 8
    if dense_bytes > (4 << 30):
        raise OzakiOverflow(
            f"dense cubes {dense_bytes/1e9:.1f} GB: unstructured pattern; "
            "use the double-double scan route")
    prep = _scales_spans_native(a, b, strict=strict)
    if prep is not None:
        ea, eb, sa, sb, span = prep
        ad = bd = None  # tile-CSR slicing below, no dense cubes
    else:
        ad, bd, ea, eb, sa, sb, span = _scales_and_slices_prep(
            a, b, strict=strict)
    tm, tk, tn = a.tm, a.tn, b.tn
    # pair-group truncation: when the data's bit span exceeds the slice
    # window (general doubles), groups p > max(sa, sb) sit below the
    # slicing truncation error (the Ozaki-scheme diagonal cut);
    # exactly representable data (span <= 7*S) keeps every group.
    pmax = (sa + sb - 2) if span <= 7 * min(sa, sb) \
        else max(1, max(sa, sb) - 1)
    _check_int32_bound(_max_pairs_per_ctile(a, b), tk, sa, sb)

    stack_rows = max(32, sa * tm)  # the TPU's int8 sublane tile, kept
    sargs = build_strip_args(a, b, block_rows=block_rows or 32, window=True)

    nt_pad = a.nt + sargs.max_ablock
    av8 = np.zeros((nt_pad, stack_rows, tk), np.int8)
    gk_pad = sargs.b_val.shape[0]
    # column layout (t, y): bv8[k][:, (t*max_b + y)*tn : ...] is B slice
    # t of k-group tile rank y
    bv8 = np.zeros((gk_pad, tk, sb * sargs.max_b * tn), np.int8)
    if ad is None:
        ozaki_slice_a_native(a, sa, stack_rows, ea, av8)
        ozaki_slice_b_native(b, sargs.max_b, sb, eb, bv8)
    else:
        exp_a = ea.reshape(a.gm, tm)[a.trow.astype(np.int64)][:, :, None]
        exp_b = eb.reshape(b.gn, tn)[b.tcol.astype(np.int64)][:, None, :]
        a_slices = _slice_int8(ad, exp_a, sa)    # (Sa, nt, tm, tk)
        b_slices = _slice_int8(bd, exp_b, sb)    # (Sb, nt, tk, tn)
        av8[: a.nt, : sa * tm] = a_slices.transpose(1, 0, 2, 3).reshape(
            a.nt, sa * tm, tk)
        bptr = b.tptr.astype(np.int64)
        cnt_b = np.diff(bptr)
        rank_b = (np.arange(b.nt, dtype=np.int64)
                  - np.repeat(bptr[:-1], cnt_b))
        kb = np.repeat(np.arange(a.gn, dtype=np.int64), cnt_b)
        slot_b = kb * sargs.max_b + rank_b
        bp = np.zeros((sb, gk_pad * sargs.max_b, tk, tn), np.int8)
        bp[:, slot_b] = b_slices
        bv8[:] = bp.reshape(sb, gk_pad, sargs.max_b, tk, tn).transpose(
            1, 3, 0, 2, 4).reshape(gk_pad, tk, sb * sargs.max_b * tn)

    return OzakiStripPlan(
        sargs=sargs, av8=av8, bv8=bv8, ea=ea, eb=eb, sa=sa, sb=sb,
        pmax=pmax,
        prep_ms=(time.perf_counter() - t0) * 1e3 - sargs.symbolic_ms,
        symbolic_ms=sargs.symbolic_ms)


# --- fused strip route: numeric step and epilogue -------------------------------

def strip_kernel_takes(tm: int, tk: int, tn: int,
                       device: torch.device) -> bool:
    """True where the fused strip route can run these tiles: any on the
    CPU (the plain version), the kernel's instantiations on CUDA."""
    return device.type != "cuda" or (
        (tm, tn) in ozaki_kernels.OZAKI_TILES and tk % 16 == 0)


def ozaki_strip_numeric(plan: OzakiStripPlan, device=None,
                        sync: bool = True):
    """Upload the plan and run the fused kernel (ops/ozaki_kernels.py:
    ozaki_strip_numeric) on `device` (None means CUDA); gather the
    candidate tiles out of the block-padded layout on the device.
    Returns (c_h, c_m, c_l, c_cnt) device tensors in candidate
    (ctrow/ctcol) order and a timing dict."""
    device = resolve_device(device)
    s = plan.sargs
    t0 = time.perf_counter()
    ops = plan.to_device(device)
    gidx = torch.from_numpy(s.gather_idx.astype(np.int64)).to(device)
    _sync(device)
    timings = {"upload_ms": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    planes = ozaki_kernels.ozaki_strip_numeric(*ops, **plan.kernel_kwargs())
    out = tuple(p.index_select(0, gidx) for p in planes)
    if sync:
        _sync(device)
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3
    return out, timings


def _ozaki_compact_arrays(ctrow, ctcol, tm, tn, ea, eb,
                          c_h, c_m, c_l, c_cnt,
                          shape: tuple[int, int]) -> TileMat:
    """Fused scale + compact on candidate-order tile stacks: select the
    structural nonzeros first, then h+m+l in f64 and the
    2^(Ea_r + Eb_c - 14) scales only on those."""
    occ = np.asarray(c_cnt) > 0
    keep = occ.any(axis=(1, 2))
    ctrow = np.asarray(ctrow)[keep]
    ctcol = np.asarray(ctcol)[keep]
    occ = occ[keep]
    h = np.asarray(c_h)[keep]
    m_ = np.asarray(c_m)[keep]
    l_ = np.asarray(c_l)[keep]
    ntk = ctrow.size
    gm, gn = cdiv(shape[0], tm), cdiv(shape[1], tn)

    tid, rcflat = np.nonzero(occ.reshape(ntk, tm * tn))
    vals = (h.reshape(ntk, tm * tn)[tid, rcflat].astype(np.float64)
            + m_.reshape(ntk, tm * tn)[tid, rcflat]
            + l_.reshape(ntk, tm * tn)[tid, rcflat])
    r = rcflat // tn
    c = rcflat % tn
    ex = (ea.reshape(-1, tm)[ctrow[tid].astype(np.int64), r]
          + eb.reshape(-1, tn)[ctcol[tid].astype(np.int64), c] - 14)
    vals = np.ldexp(vals, ex)
    tile_key = ctrow[tid].astype(np.int64) * gn + ctcol[tid]
    return _build_tilemat(
        shape=shape, tm=tm, tn=tn, tile_key=tile_key,
        rc=rcflat.astype(INDEX_DTYPE), val=vals, gm=gm, gn=gn)


def _host(planes) -> tuple[np.ndarray, ...]:
    """Device (or host) tensors -> NumPy arrays on the host."""
    return tuple(np.asarray(p.cpu()) if isinstance(p, torch.Tensor)
                 else np.asarray(p) for p in planes)


def ozaki_strip_compact(plan: OzakiStripPlan, c_h, c_m, c_l, c_cnt,
                        shape: tuple[int, int]) -> TileMat:
    """Download the candidate-order planes and run the host epilogue."""
    s = plan.sargs
    return _ozaki_compact_arrays(s.ctrow, s.ctcol, s.tm, s.tn, plan.ea,
                                 plan.eb, *_host((c_h, c_m, c_l, c_cnt)),
                                 shape)


def _spgemm_ozaki_strip(a: TileMat, b: TileMat, *, device, sync: bool,
                        strict: bool, note: str):
    """spgemm_ozaki through the fused strip kernel. Raises
    WindowInfeasible before any launch where the pattern has no windowed
    plan."""
    from spgemm_tpu_torch.ops.spgemm import SpGEMMResult

    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    plan = build_ozaki_strip(a, b, strict=strict)
    timings["symbolic_ms"] = plan.symbolic_ms
    timings["prep_ms"] = max(
        0.0, (time.perf_counter() - t0) * 1e3 - plan.symbolic_ms)

    (c_h, c_m, c_l, c_cnt), t_num = ozaki_strip_numeric(plan, device=device,
                                                        sync=sync)
    timings.update(t_num)

    t0 = time.perf_counter()
    c = ozaki_strip_compact(plan, c_h, c_m, c_l, c_cnt, (a.m, b.n))
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3

    s = plan.sargs
    stats = {
        "num_pairs": float(s.num_pairs),
        "numblkC_candidate": float(s.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": f"ozaki-strip(S={plan.sa}x{plan.sb})"
                   + (f"({note})" if note else ""),
        "slices": float(plan.sa * plan.sb),
    }
    return SpGEMMResult(c=c, schedule=plan, timings_ms=timings, stats=stats)


# --- slab engine: plan -----------------------------------------------------------

@dataclasses.dataclass
class OzakiPlan:
    """Plan of the slab engine: the Gustavson slab geometry carrying int8
    slice planes."""

    base: GustavsonPlan          # geometry + C-tile dictionary
    a_occ: np.ndarray            # (gk, max_a*tm, tk) int8 0/1 occupancy
    b_occ: np.ndarray            # (gk, tk, max_b*tn) int8
    a_sl: np.ndarray             # (Sa, gk, max_a*tm, tk) int8
    b_sl: np.ndarray             # (Sb, gk, tk, max_b*tn) int8
    ea: np.ndarray               # (gm*tm,) int64 per-row scale exponents
    eb: np.ndarray               # (gn*tn,) int64 per-col scale exponents
    perm: np.ndarray             # (n_slots,) int32 pair order sorted by seg
    bounds: np.ndarray           # (nt_c+1,) int32 segment bounds in perm
    sa: int
    sb: int
    prep_ms: float = 0.0
    symbolic_ms: float = 0.0

    @property
    def num_pairs(self) -> int:
        return self.base.num_pairs

    @property
    def ctrow(self):
        return self.base.ctrow

    @property
    def ctcol(self):
        return self.base.ctcol

    @property
    def nt_c(self) -> int:
        return self.base.nt_c

    def padding_ratio(self) -> float:
        return self.base.padding_ratio()

    @classmethod
    def from_numpy(cls, fields: dict) -> "OzakiPlan":
        """Port plan from the JAX package's OzakiPlan fields given as NumPy
        arrays (e.g. {f.name: getattr(plan, f.name)} of a spgemm_tpu
        plan); `base`, the JAX GustavsonPlan, goes through
        GustavsonPlan.from_numpy."""
        base = fields["base"]
        names = {f.name for f in dataclasses.fields(cls)} - {"base"}
        return cls(base=GustavsonPlan.from_numpy(
            {f.name: getattr(base, f.name)
             for f in dataclasses.fields(base)}),
            **{k: v for k, v in fields.items() if k in names})

    def to_device(self, device) -> tuple[torch.Tensor, ...]:
        """(a_sl, b_sl, a_occ, b_occ, seg) on `device`, in the argument
        order of ozaki_core."""
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                     for x in (self.a_sl, self.b_sl, self.a_occ, self.b_occ,
                               self.base.seg))

    def core_kwargs(self) -> dict:
        return dict(self.base.numeric_kwargs(), sa=self.sa, sb=self.sb)


def build_ozaki_plan(a: TileMat, b: TileMat,
                     strict: bool = False) -> OzakiPlan:
    """Slice the f64 tile values and pack them into the Gustavson slab
    layout (the base plan's slot formulas, occupancy slabs and C-tile
    dictionary). Raises OzakiOverflow when the occupancy slabs, slab or
    slice bytes are past their budgets, the int32 accumulation bound
    cannot be guaranteed, or tk > 1040 (the f32 slice products' bound)."""
    # cheap tile-pointer feasibility before the base plan builds its occ
    # slabs (pathological k-column skew can blow gk*max_a padding)
    acsc_ptr, _ = a.csc_view()
    max_a0 = max(1, int(np.diff(acsc_ptr).max())) if a.nt else 1
    max_b0 = max(1, int(np.diff(b.tptr).max())) if b.nt else 1
    occ_bytes = a.gn * (max_a0 * a.tm * a.tn + max_b0 * b.tm * b.tn) * 4
    if occ_bytes > (4 << 30):
        raise OzakiOverflow(
            f"k-group padding explodes (occ slabs {occ_bytes/1e9:.1f} GB): "
            "unstructured pattern; use the double-double scan route")
    base = build_gustavson_plan(a, b, dtype=np.float32, values=False)

    t_prep = time.perf_counter()
    a_sl, b_sl, ea, eb, sa, sb = slice_and_pack(a, b, base, strict=strict)
    # int8 occupancy: the count products are exact and the upload 4x
    # smaller than f32 slabs
    a_occ = base.a3_occ.astype(np.int8)
    b_occ = base.b3_occ.astype(np.int8)
    base.a3_occ = base.b3_occ = None
    # the pair order sorted by destination segment and its boundaries
    # (padding pairs sort past bounds[nt_c]): the JAX package's
    # scatter-free combine runs on them; kept so both plans hold the same
    # arrays
    perm = np.argsort(base.seg, kind="stable").astype(np.int32)
    bounds = np.searchsorted(
        base.seg[perm], np.arange(base.nt_c + 1)).astype(np.int32)

    prep_ms = (time.perf_counter() - t_prep) * 1e3
    return OzakiPlan(
        base=base, a_occ=a_occ, b_occ=b_occ, a_sl=a_sl, b_sl=b_sl,
        ea=ea, eb=eb, perm=perm, bounds=bounds, sa=sa, sb=sb,
        prep_ms=prep_ms + base.prep_ms, symbolic_ms=base.symbolic_ms)


def slice_and_pack(a: TileMat, b: TileMat, base: GustavsonPlan,
                   strict: bool = False):
    """Value-dependent half of the plan build: scales, adaptive slice
    counts, int8 slicing, slab packing and the feasibility checks; also
    OzakiExecutor.update_values' refresh. Returns (a_sl, b_sl, ea, eb,
    sa, sb)."""
    gk, max_a, max_b = base.gk, base.max_a, base.max_b
    tm, tk, tn = base.tm, base.tk, base.tn

    _check_f32_products(tk)
    # geometry-only feasibility first, before the f64 dense tile cubes
    slab_bytes = gk * max_a * max_b * tm * tn * 4
    dense_bytes = (a.nt * tm * tk + b.nt * tk * tn) * 8
    slice_ub = MAX_SLICES * (gk * max_a * tm * tk + gk * max_b * tk * tn)
    if (slab_bytes > (4 << 30) or dense_bytes > (4 << 30)
            or slice_ub > (8 << 30)):
        raise OzakiOverflow(
            f"slab padding explodes (pair buffer {slab_bytes/1e9:.1f} GB, "
            f"dense cubes {dense_bytes/1e9:.1f} GB): unstructured pattern; "
            "use the double-double scan route")

    ad, bd, ea, eb, sa, sb, _span = _scales_and_slices_prep(
        a, b, strict=strict)

    # int32 accumulation bound (per C element, per pair group)
    seg_real = base.seg[base.seg < base.nt_c]
    max_pairs = int(np.bincount(seg_real).max()) if seg_real.size else 1
    _check_int32_bound(max_pairs, tk, sa, sb)
    exp_a = ea.reshape(a.gm, tm)[a.trow.astype(np.int64)][:, :, None]
    exp_b = eb.reshape(b.gn, tn)[b.tcol.astype(np.int64)][:, None, :]
    a_slices = _slice_int8(ad, exp_a, sa)                   # (Sa, nt, tm, tk)
    b_slices = _slice_int8(bd, exp_b, sb)                   # (Sb, nt, tk, tn)

    # the slab layout, with build_gustavson_plan's slot formulas
    acsc_ptr, acsc_perm = a.csc_view()
    cnt_a = np.diff(acsc_ptr).astype(np.int64)
    rank_a = np.arange(a.nt, dtype=np.int64) - np.repeat(
        acsc_ptr[:-1].astype(np.int64), cnt_a)
    slot_a = np.repeat(np.arange(gk, dtype=np.int64), cnt_a) * max_a + rank_a
    a_sl = np.zeros((sa, gk * max_a, tm, tk), np.int8)
    a_sl[:, slot_a] = a_slices[:, acsc_perm]
    a_sl = a_sl.reshape(sa, gk, max_a * tm, tk)

    bptr = b.tptr.astype(np.int64)
    cnt_b = np.diff(bptr)
    rank_b = np.arange(b.nt, dtype=np.int64) - np.repeat(bptr[:-1], cnt_b)
    slot_b = np.repeat(np.arange(gk, dtype=np.int64), cnt_b) * max_b + rank_b
    b_pack = np.zeros((sb, gk * max_b, tk, tn), np.int8)
    b_pack[:, slot_b] = b_slices
    b_sl = np.ascontiguousarray(b_pack.reshape(sb, gk, max_b, tk, tn)
                                .transpose(0, 1, 3, 2, 4)
                                .reshape(sb, gk, tk, max_b * tn))
    return a_sl, b_sl, ea, eb, sa, sb


# --- slab engine: numeric step and epilogue -----------------------------------

def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _acc3(h, m, l, x):
    """Add the exact f32 term x into the triple-float accumulator
    (h, m, l) by cascaded TwoSum: only l's own sum rounds, so the triple
    carries ~70 significand bits and every <= 53-bit result reconstructs
    exactly in f64. Eager elementwise ops, one kernel each: nothing may
    fuse them into FMAs or reorder them, or TwoSum stops being exact."""
    h, e = _two_sum(h, x)
    m, e2 = _two_sum(m, e)
    return h, m, l + e2


def ozaki_core(a_sl, b_sl, a3_occ, b3_occ, seg, *, gk: int, max_a: int,
               max_b: int, tm: int, tn: int, nt_c: int, sa: int, sb: int):
    """The slab engine on the operands' device: for each pair group
    p = s + t, the Sa*Sb slice-pair slab products as f32 `bmm`s of the
    int8 planes widened to f32 (exact, see _check_f32_products), cast to
    int32 and summed, one int32 `index_add_` into the C tiles, then the
    triple-float combine. Returns (c_h, c_m, c_l, c_cnt), each (nt_c, tm,
    tn): (h, m, l) f32 are the unscaled sums sum_p M_p * 2^(-7p) (the
    host applies the 2^(Ea_r + Eb_c - 14) scales in f64), c_cnt int32."""
    dev = a_sl.device
    stride = nt_c + 1
    seg = seg.long()

    def seg_sum(prod):  # int32 slab products -> per-C-tile int32 sums
        acc = torch.zeros(stride, tm, tn, dtype=torch.int32, device=dev)
        acc.index_add_(0, seg, to_pairs(prod, gk, max_a, max_b, tm, tn)
                       .reshape(-1, tm, tn))
        return acc[:nt_c]

    c_h = torch.zeros(nt_c, tm, tn, dtype=torch.float32, device=dev)
    c_m = torch.zeros_like(c_h)
    c_l = torch.zeros_like(c_h)
    with full_fp32():
        af = a_sl.to(torch.float32)
        bf = b_sl.to(torch.float32)
        for p in range(sa + sb - 1):
            m = None
            for s in range(max(0, p - sb + 1), min(sa - 1, p) + 1):
                d = torch.bmm(af[s], bf[p - s]).to(torch.int32)
                m = d if m is None else m.add_(d)
            mp = seg_sum(m)
            del m
            # exact int32 -> double-float split, scaled by 2^(-7p) (exact:
            # a power-of-two multiply), then triple-float accumulate
            mh = mp.to(torch.float32)
            ml = (mp - mh.to(torch.int32)).to(torch.float32)
            scale = 2.0 ** (-7 * p)
            c_h, c_m, c_l = _acc3(c_h, c_m, c_l, mh * scale)
            c_h, c_m, c_l = _acc3(c_h, c_m, c_l, ml * scale)
        del af, bf
        cnt = seg_sum(torch.bmm(a3_occ.to(torch.float32),
                                b3_occ.to(torch.float32)).to(torch.int32))
    return c_h, c_m, c_l, cnt


def ozaki_numeric(plan: OzakiPlan, device=None, sync: bool = True):
    """Upload the plan and run ozaki_core on `device` (None means CUDA).
    Returns device (c_h, c_m, c_l, c_cnt) and a timing dict."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    ops = plan.to_device(device)
    _sync(device)
    timings = {"upload_ms": (time.perf_counter() - t0) * 1e3}
    t0 = time.perf_counter()
    out = ozaki_core(*ops, **plan.core_kwargs())
    if sync:
        _sync(device)
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3
    return out, timings


def time_ozaki(plan: OzakiPlan, *, warmup: int = 3, iters: int = 20,
               device=None) -> float:
    """Median device milliseconds of one ozaki_core call on the uploaded
    plan (CUDA events around each call after `warmup` untimed ones)."""
    ops = plan.to_device(resolve_device(device))
    kw = plan.core_kwargs()
    return cuda_event_ms(lambda: ozaki_core(*ops, **kw), warmup=warmup,
                         iters=iters)


def ozaki_assemble(plan: OzakiPlan, c_h, c_m, c_l, c_cnt,
                   shape: tuple[int, int]) -> np.ndarray:
    """Host epilogue on the full candidate cube: f64 = (h + m + l) *
    2^(Ea_r + Eb_c - 14) by np.ldexp (exact, full f64 exponent range).
    Returns the (nt_c, tm, tn) f64 values; ozaki_compact scales only the
    kept nonzeros."""
    base = plan.base
    h, m, l = _host((c_h, c_m, c_l))
    v = h.astype(np.float64) + m + l
    er = plan.ea.reshape(-1, base.tm)[np.asarray(base.ctrow, np.int64)]
    ec = plan.eb.reshape(-1, base.tn)[np.asarray(base.ctcol, np.int64)]
    return np.ldexp(v, (er[:, :, None] + ec[:, None, :] - 14).astype(np.int64))


def ozaki_compact(plan: OzakiPlan, c_h, c_m, c_l, c_cnt,
                  shape: tuple[int, int]) -> TileMat:
    """Download the planes and run the host epilogue: select the
    structural nonzeros, then scale only those (_ozaki_compact_arrays)."""
    base = plan.base
    return _ozaki_compact_arrays(base.ctrow, base.ctcol, base.tm, base.tn,
                                 plan.ea, plan.eb,
                                 *_host((c_h, c_m, c_l, c_cnt)), shape)


# --- entry point -------------------------------------------------------------

def spgemm_ozaki(a: TileMat, b: TileMat, *, device=None, sync: bool = True,
                 strict: bool = False, note: str = ""):
    """Full f64 multiply C = A @ B through the Ozaki-slice engine on
    `device` (None means CUDA); returns a SpGEMMResult (TileMat C, f64
    values) shaped like the other tiled routes. The fused strip kernel
    runs where it can; where the pattern has no windowed strip plan or, on
    CUDA, the kernel has no instantiation for the tiles, the slab engine
    runs (stats["backend"] "ozaki(S=AxB)(xla-fallback)", the JAX
    package's name). Raises OzakiOverflow when the int32 accumulation
    bound fails (or, with strict, on extreme multi-scale data): callers
    then run the double-double scan route."""
    from spgemm_tpu_torch.ops.spgemm import SpGEMMResult, _compact_to_tilemat

    device = resolve_device(device)
    if a.n != b.m or a.tn != b.tm:
        raise ValueError(f"operands do not chain: A {a.shape} in {a.tm}x"
                         f"{a.tn} tiles, B {b.shape} in {b.tm}x{b.tn} tiles")
    if strip_kernel_takes(a.tm, a.tn, b.tn, device):
        try:
            return _spgemm_ozaki_strip(a, b, device=device, sync=sync,
                                       strict=strict, note=note)
        except WindowInfeasible:
            pass
    note = (note + "+" if note else "") + "xla-fallback"

    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    plan = build_ozaki_plan(a, b, strict=strict)
    timings["symbolic_ms"] = max(
        0.0, (time.perf_counter() - t0) * 1e3 - plan.prep_ms)
    timings["prep_ms"] = plan.prep_ms
    base = plan.base

    if base.nt_c == 0:
        c = _compact_to_tilemat(
            base.ctrow, base.ctcol, np.zeros((0, base.tm, base.tn)),
            np.zeros((0, base.tm, base.tn), np.float32), (a.m, b.n),
            a.tm, b.tn)
        return SpGEMMResult(c=c, schedule=plan,
                            timings_ms={**timings, "upload_ms": 0.0,
                                        "numeric_ms": 0.0,
                                        "compact_ms": 0.0},
                            stats={"backend": "ozaki", "num_pairs": 0.0,
                                   "numblkC_candidate": 0.0,
                                   "numblkC": 0.0, "nnzC": 0.0})

    (c_h, c_m, c_l, c_cnt), t_num = ozaki_numeric(plan, device=device,
                                                  sync=sync)
    timings.update(t_num)

    t0 = time.perf_counter()
    c = ozaki_compact(plan, c_h, c_m, c_l, c_cnt, (a.m, b.n))
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3

    stats = {
        "num_pairs": float(base.num_pairs),
        "numblkC_candidate": float(base.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": f"ozaki(S={plan.sa}x{plan.sb})({note})",
        "padding_ratio": base.padding_ratio(),
        "slices": float(plan.sa * plan.sb),
    }
    return SpGEMMResult(c=c, schedule=plan, timings_ms=timings, stats=stats)
