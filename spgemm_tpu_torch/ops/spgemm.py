"""SpGEMM orchestrator (port of `spgemm_tpu/ops/spgemm.py`): the strip
route (tile, plan, run the strip numeric phase on the device, compact back
to the tiled format and to CSR), the ESC scan route for unstructured
patterns (CSR in, CSR out), the Ozaki route for f64 on structured
patterns and the two pair backends (backend "pallas": the per-C-tile pair
kernel; "xla": the same pairs as torch ops, f32 or f64), with per-phase
timings and the JAX package's auto router, f64 routing included.

Routes the port does not have yet raise NotImplementedError naming their
ROADMAP.md item; nothing falls back to another route.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from spgemm_tpu_torch.models.csr import CSR, INDEX_DTYPE, flop_count_spgemm
from spgemm_tpu_torch.models.tile import (TileMat, _build_tilemat, cdiv,
                                          csr_to_tiles)
from spgemm_tpu_torch.ops import esc, kernels, numeric, pair_kernels
from spgemm_tpu_torch.ops.gustavson import build_strip_args, strip_numeric
from spgemm_tpu_torch.ops.ozaki import OzakiOverflow, spgemm_ozaki
from spgemm_tpu_torch.ops.symbolic import build_pair_schedule
from spgemm_tpu_torch.utils.timing import resolve_device

# ROADMAP.md "Queue 1" items that port the routes this module refuses
_ROADMAP_ITEM = {
    "digit": "ESC unstructured route: digit mode",
    "f64": "f64",
    "gustavson": "Orchestrator fallbacks",
    "dense": "Orchestrator fallbacks",
}
# pairs the XLA pair backend multiplies at once (bounds its gathered tiles)
DEFAULT_CHUNK = 32768


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to spgemm_tpu_torch yet (ROADMAP.md, "
        f"Queue 1: {_ROADMAP_ITEM[key]})")


@dataclasses.dataclass
class SpGEMMResult:
    c: TileMat | None  # None on spgemm_csr's ESC route (no tiles)
    schedule: object  # StripArgs, ScanPlan, OzakiStripPlan or PairSchedule
    timings_ms: dict[str, float]
    stats: dict[str, float]


def _compact_to_tilemat(ctrow, ctcol, c_val, c_cnt, shape, tm, tn) -> TileMat:
    """Dense per-tile accumulators -> TileMat; prunes structurally empty
    candidate tiles. c_cnt is read only as > 0."""
    occ = c_cnt > 0
    keep = occ.any(axis=(1, 2))
    ctrow, ctcol = ctrow[keep], ctcol[keep]
    occ, c_val = occ[keep], c_val[keep]
    ntk = ctrow.size
    gm, gn = cdiv(shape[0], tm), cdiv(shape[1], tn)

    tid, rcflat = np.nonzero(occ.reshape(ntk, tm * tn))
    vals = c_val.reshape(ntk, tm * tn)[tid, rcflat].astype(np.float64)
    tile_key = ctrow[tid].astype(np.int64) * gn + ctcol[tid]
    # (tid ascending, rcflat row-major ascending) is already the canonical
    # order _build_tilemat expects
    return _build_tilemat(shape=shape, tm=tm, tn=tn, tile_key=tile_key,
                          rc=rcflat.astype(INDEX_DTYPE), val=vals, gm=gm,
                          gn=gn)


def _resolve_backend(a: TileMat, b: TileMat, backend: str,
                     device: torch.device) -> None:
    """Pass for the strip route; raise NotImplementedError for what is not
    ported. The gate is the CUDA kernel's own limit (its instantiated
    tile shapes); the plain version on the CPU takes any tiles."""
    if backend in ("auto", "strip"):
        if device.type == "cpu" or ((a.tm, b.tn) in kernels.SUPPORTED_TILES
                                    and a.tn % kernels.TK_MULTIPLE == 0):
            return
        raise _not_ported(
            f"a backend for {a.tm}x{b.tn} tiles with tk={a.tn} on CUDA (the "
            f"strip kernel takes (tm, tn) in {kernels.SUPPORTED_TILES} and "
            f"tk a multiple of {kernels.TK_MULTIPLE})", "gustavson")
    if backend in _ROADMAP_ITEM:
        raise _not_ported(f"backend={backend!r}", backend)
    raise ValueError(f"unknown backend {backend!r}")


def spgemm(a: TileMat, b: TileMat, *, compute_dtype=torch.float32,
           backend: str = "auto", device=None) -> SpGEMMResult:
    """Sparse C = A @ B on the tiled format through the strip route
    (backend "auto" or "strip"), in f64 through the Ozaki route (backend
    "ozaki", whatever compute_dtype), through the ESC scan route (backend
    "esc": f32, or the double-double f64 scan), or through a pair
    backend: "pallas" (the per-C-tile pair kernel, float32) or "xla"
    (torch ops, float32 or float64). `device` None means CUDA."""
    if backend == "ozaki":
        return spgemm_ozaki(a, b, device=device)
    f64 = esc.is_f64(compute_dtype)
    dev = resolve_device(device)
    if backend == "esc":
        return _spgemm_tiles_esc(a, b, f64=f64, device=dev)
    if backend in ("pallas", "xla"):
        return _spgemm_pairs(a, b, backend=backend, f64=f64, device=dev)
    if f64:
        raise _not_ported(f"compute_dtype={compute_dtype}", "f64")
    _resolve_backend(a, b, backend, dev)
    return _spgemm_strip(a, b, device=dev)


def _spgemm_pairs(a: TileMat, b: TileMat, *, backend: str, f64: bool,
                  device, chunk: int = DEFAULT_CHUNK) -> SpGEMMResult:
    """The pair backends (`spgemm_tpu/ops/spgemm.py:292-355`): schedule,
    upload of the dense and occupancy planes, numeric, compaction."""
    if backend == "pallas":
        pair_kernels.check_pair_dtype(torch.float64 if f64 else torch.float32)
        if device.type == "cuda" and (a.tm, b.tn) not in \
                pair_kernels.PAIR_TILES:
            raise NotImplementedError(
                f"the pair kernel takes (tm, tn) in {pair_kernels.PAIR_TILES} "
                f"on CUDA, got {a.tm}x{b.tn}; use backend='xla' or 'strip'")
    timings: dict[str, float] = {}
    t0 = time.perf_counter()
    sched = build_pair_schedule(a, b)
    timings["symbolic_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    np_dt = np.float64 if f64 else np.float32
    up = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    a_val, b_val = up(a.dense(np_dt)), up(b.dense(np_dt))
    # occupancy travels as uint8 and widens on the device: to bf16 0/1 for
    # the pair kernel, to the f32 that the xla backend's counts use
    occ_dt = torch.bfloat16 if backend == "pallas" else torch.float32
    a_occ, b_occ = up(a.occ()).to(occ_dt), up(b.occ()).to(occ_dt)
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    if backend == "pallas":
        c_val_d, c_cnt_d = pair_kernels.pair_accumulate_cuda(
            a_val, a_occ, b_val, b_occ, up(sched.pa), up(sched.pb),
            up(sched.pair_ptr), num_segments=sched.nt_c)
    else:
        pa, pb, seg = numeric.pad_pairs(sched.pa, sched.pb, sched.seg,
                                        sched.nt_c, chunk)
        c_val_d, c_cnt_d = numeric.pair_accumulate(
            a_val, a_occ, b_val, b_occ, up(pa), up(pb), up(seg),
            num_segments=sched.nt_c, chunk=chunk)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c = _compact_to_tilemat(sched.ctrow, sched.ctcol,
                            c_val_d.cpu().numpy().astype(np.float64),
                            c_cnt_d.cpu().numpy(), (a.m, b.n), a.tm, b.tn)
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3
    stats = {
        "num_pairs": float(sched.num_pairs),
        "numblkC_candidate": float(sched.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": backend,
    }
    return SpGEMMResult(c=c, schedule=sched, timings_ms=timings, stats=stats)


def _spgemm_tiles_esc(a: TileMat, b: TileMat, *, f64: bool,
                      device) -> SpGEMMResult:
    """backend="esc" on tiles (`spgemm_tpu/ops/spgemm.py:271-291`): the ESC
    engine works on CSR, so A and B go to CSR, through spgemm_esc in the
    compute dtype, and C back to tiles of A's height and B's width."""
    c, timings, plan = esc.spgemm_esc(
        a.to_csr(), b.to_csr(),
        dtype=torch.float64 if f64 else torch.float32, device=device)
    c_tiles = csr_to_tiles(c, a.tm, b.tn)
    stats = {
        "num_pairs": float(plan.num_products),
        "numblkC_candidate": float(c_tiles.nt),
        "numblkC": float(c_tiles.nt),
        "nnzC": float(c.nnz),
        "backend": "esc",
    }
    return SpGEMMResult(c=c_tiles, schedule=plan, timings_ms=timings,
                        stats=stats)


def _spgemm_strip(a: TileMat, b: TileMat, *, device) -> SpGEMMResult:
    """The strip branch of the JAX package's _spgemm_gustavson."""
    timings: dict[str, float] = {}
    sargs = build_strip_args(a, b)
    timings["prep_ms"] = sargs.prep_ms
    timings["symbolic_ms"] = sargs.symbolic_ms

    t0 = time.perf_counter()
    # upload + kernel + device compaction + download (syncs on download)
    c_val, c_occ = strip_numeric(sargs, device)
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3
    timings["upload_ms"] = 0.0

    t0 = time.perf_counter()
    c = _compact_to_tilemat(sargs.ctrow, sargs.ctcol,
                            c_val.astype(np.float64), c_occ,
                            (a.m, b.n), a.tm, b.tn)
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3
    stats = {
        "num_pairs": float(sargs.num_pairs),
        "numblkC_candidate": float(sargs.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": "strip",
    }
    return SpGEMMResult(c=c, schedule=sargs, timings_ms=timings, stats=stats)


def tile_occupancy_estimate(a: CSR, tm: int = 16, tn: int = 128) -> float:
    """Mean nnz per occupied tile, computed without tiling. Low values
    mean the tiled formulation is defeated (unstructured pattern)."""
    if a.nnz == 0:
        return 0.0
    keys = ((a.rows_expanded().astype(np.int64) // tm) * cdiv(a.n, tn)
            + a.indices.astype(np.int64) // tn)
    return a.nnz / max(1, np.unique(keys).size)


# Routing thresholds, unchanged from the JAX package (tuned there on the
# TPU suite; retuning them on the card is a ROADMAP item). Tiles sparser
# than ESC_OCCUPANCY_TH products per occupied 16x128 tile, or with
# moderate occupancy and low MXU reuse, route "auto" to the ESC engine.
ESC_OCCUPANCY_TH = 8.0
ESC_STRUCTURED_OCC_TH = 384.0
ESC_REUSE_TH = 32.0


def _mxu_reuse(a: CSR, b: CSR | None, aat: bool) -> float:
    """Products per A-nonzero (mean partner-row length), vectorized."""
    if a.nnz == 0:
        return 0.0
    if aat:
        cnt = np.bincount(a.indices, minlength=a.n)
        f = int(cnt[a.indices].sum())
    else:
        bb = a if b is None else b
        f = int(np.diff(bb.indptr).astype(np.int64)[a.indices].sum())
    return f / a.nnz


def spgemm_csr(a: CSR, b: CSR | None = None, *, tm: int = 16, tn: int = 128,
               aat: bool = False, backend: str = "auto",
               compute_dtype=torch.float32,
               device=None) -> tuple[CSR, SpGEMMResult]:
    """CSR-level API: C = A @ B with B as A (A^2), A^T (aat) or an
    explicit matrix, on `device` (None means CUDA). Returns CSR C with the
    result record.

    backend "auto" keeps the JAX package's router: unstructured patterns
    go to the ESC scan route (no tiling), the rest to the strip route.
    backend "esc", "strip", "ozaki", "pallas" and "xla" pick a route
    ("xla" also runs float64 on the tiles). compute_dtype
    float64 follows the JAX package's f64 routing: integer data whose f32
    sums are exact takes the f32 route; otherwise structured patterns run
    the Ozaki route (strict: OzakiOverflow sends them on), and the rest,
    like backend "esc", the double-double scan."""
    f64 = esc.is_f64(compute_dtype)
    if backend == "esc":
        return _spgemm_csr_esc(a, b, aat=aat, f64=f64, device=device)
    if backend == "auto":
        if f64:
            if _f32_exact_for(a, b, aat):
                c, res = spgemm_csr(a, b, tm=tm, tn=tn, aat=aat,
                                    compute_dtype=torch.float32,
                                    device=device)
                res.stats["backend"] = f"{res.stats['backend']}(f64-exact-int)"
                return c, res
            if tile_occupancy_estimate(a, tm, tn) >= ESC_OCCUPANCY_TH:
                try:
                    return _spgemm_csr_tiled_f64(a, b, aat=aat, tm=tm, tn=tn,
                                                 device=device)
                except OzakiOverflow:
                    pass
            return _spgemm_csr_esc(a, b, aat=aat, f64=True, device=device)
        occ = tile_occupancy_estimate(a, tm, tn)
        if occ < ESC_OCCUPANCY_TH or (
                occ < ESC_STRUCTURED_OCC_TH
                and _mxu_reuse(a, b, aat) < ESC_REUSE_TH):
            return _spgemm_csr_esc(a, b, aat=aat, f64=False, device=device)
    elif f64 and backend not in ("ozaki", "pallas", "xla"):
        raise _not_ported(f"compute_dtype=float64 with backend={backend!r}",
                          "f64")
    at = csr_to_tiles(a, tm, tn)
    # inner blocking must agree: A tiles (tm, tn) -> B tiles (tn, tn)
    bt = _tile_b_role(a, b, at, aat, tm, tn)
    res = spgemm(at, bt, backend=backend,
                 compute_dtype=torch.float64 if f64 else torch.float32,
                 device=device)
    return _csr_result_tail(res, a, b, aat)


def _f32_exact_for(a: CSR, b: CSR | None, aat: bool) -> bool:
    """True when the f32 route is provably exact for this f64 data: all
    values are integers and every partial sum of C stays below 2^24. Each
    C element accumulates at most max-row-nnz(A) products of magnitude
    <= Vmax_A * Vmax_B."""
    av = a.data
    if av.size == 0:
        return True
    if not np.array_equal(np.trunc(av), av):
        return False
    vmax_a = float(np.abs(av).max())
    if b is None:
        vmax_b = vmax_a          # A^2 or AAT: same values
    else:
        bd = b.data
        if bd.size and not np.array_equal(np.trunc(bd), bd):
            return False
        vmax_b = float(np.abs(bd).max()) if bd.size else 0.0
    kmax = int(np.diff(a.indptr).max()) if a.nnz else 0
    return vmax_a * vmax_b * max(kmax, 1) < 2 ** 24


def _spgemm_csr_tiled_f64(a: CSR, b: CSR | None, *, aat: bool, tm: int,
                          tn: int, device) -> tuple[CSR, SpGEMMResult]:
    """Structured-f64 branch of spgemm_csr: tile, then the Ozaki route
    with strict=True, so data whose per-row significand span is far
    beyond the slice window raises OzakiOverflow and the caller runs the
    double-double scan. Raises OzakiOverflow when the int32 accumulation
    bound fails too."""
    at = csr_to_tiles(a, tm, tn)
    bt = _tile_b_role(a, b, at, aat, tm, tn)
    res = spgemm_ozaki(at, bt, device=device, strict=True)
    return _csr_result_tail(res, a, b, aat)


def _spgemm_csr_esc(a: CSR, b: CSR | None, *, aat: bool, f64: bool,
                    device) -> tuple[CSR, SpGEMMResult]:
    """The ESC route of spgemm_csr: no tiling, CSR in and CSR out. The
    result's `c` is None (there is no tile grid on this route); its
    schedule is the ScanPlan."""
    if aat:
        if b is not None:
            raise ValueError("pass either b or aat=True, not both")
        b = a.transpose()
    elif b is None:
        if a.m != a.n:
            raise ValueError("C = A^2 requires square A")
        b = a
    c, timings, plan = esc.spgemm_esc(
        a, b, dtype=torch.float64 if f64 else torch.float32, device=device)
    nnz_cub = flop_count_spgemm(a, b)
    stats = {
        "num_pairs": float(plan.num_products),
        "numblkC_candidate": 0.0,
        "numblkC": 0.0,
        "nnzC": float(c.nnz),
        "nnzCub": float(nnz_cub),
        "backend": "esc",
    }
    if c.nnz:
        stats["compression"] = nnz_cub / c.nnz
    if timings["numeric_ms"] > 0:
        stats["gflops"] = 2.0 * nnz_cub / (timings["numeric_ms"] * 1e6)
    return c, SpGEMMResult(c=None, schedule=plan, timings_ms=timings,
                           stats=stats)


def _tile_b_role(a: CSR, b: CSR | None, at: TileMat, aat: bool,
                 tm: int, tn: int) -> TileMat:
    """Derive the tiled B-role matrix (A, A^T, or explicit B) with the
    inner-blocking agreement rule (A tiles (tm, tn) -> B tiles (tn, tn))."""
    if aat:
        if b is not None:
            raise ValueError("pass either b or aat=True, not both")
        return at.transpose_tiles() if tm == tn else csr_to_tiles(
            a.transpose(), tn, tn)
    if b is None:
        if a.m != a.n:
            raise ValueError("C = A^2 requires square A")
        return at if tm == tn else csr_to_tiles(a, tn, tn)
    return csr_to_tiles(b, tn, tn)


def _csr_result_tail(res: SpGEMMResult, a: CSR, b: CSR | None,
                     aat: bool) -> tuple[CSR, SpGEMMResult]:
    """CSR extraction + reference-contract stats (nnzCub, compression,
    GFLOPS over the numeric wall time)."""
    c_csr = res.c.to_csr()
    nnz_cub = flop_count_spgemm(
        a, b if b is not None else (a.transpose() if aat else a))
    res.stats["nnzCub"] = float(nnz_cub)
    if res.stats["nnzC"] > 0:
        res.stats["compression"] = nnz_cub / res.stats["nnzC"]
    if res.timings_ms["numeric_ms"] > 0:
        res.stats["gflops"] = 2.0 * nnz_cub / (res.timings_ms["numeric_ms"]
                                               * 1e6)
    return c_csr, res
