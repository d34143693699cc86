"""SpGEMM orchestrator (port of `spgemm_tpu/ops/spgemm.py`): tile, plan,
run the numeric phase on the device, compact back to the tiled format
and to CSR, with per-phase timings and the JAX package's routers.

Tiled routes, picked by `_resolve_backend` in the JAX package's order:
the strip kernel where it runs, then the dense matmul (f32), then the
Gustavson slab route, then the pair gather ("xla"). Beside them: the ESC
scan route for unstructured patterns (CSR in, CSR out), the Ozaki route
for f64 on structured patterns (the fused kernel, else the slab engine)
and the per-C-tile pair kernel (backend "pallas"). The dense, slab and
"xla" routes are torch ops, as the JAX package leaves them to XLA.

f64 runs as the JAX package runs it with jax_enable_x64 on: the dense,
slab and "xla" routes multiply in float64 (the port has no x64 switch).
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
from spgemm_tpu_torch.ops.esc import _sync
from spgemm_tpu_torch.ops.gustavson import (build_gustavson_plan,
                                            build_strip_args, full_fp32,
                                            gustavson_numeric, product_dtype,
                                            strip_numeric)
from spgemm_tpu_torch.ops.ozaki import OzakiOverflow, spgemm_ozaki
from spgemm_tpu_torch.ops.symbolic import build_pair_schedule
from spgemm_tpu_torch.utils.timing import cuda_event_ms, resolve_device

# ROADMAP.md "Queue 1" items that port the routes the port refuses
_ROADMAP_ITEM = {"digit": "ESC unstructured route: digit mode"}
# pairs the XLA pair backend multiplies at once (bounds its gathered tiles)
DEFAULT_CHUNK = 32768
# byte budgets of the slab and dense routes, the JAX package's numbers
SLAB_BYTES = 4 << 30
DENSE_BYTES = 6 << 30


def _not_ported(what: str, key: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to spgemm_tpu_torch yet (ROADMAP.md, "
        f"Queue 1: {_ROADMAP_ITEM[key]})")


@dataclasses.dataclass
class SpGEMMResult:
    c: TileMat | None  # None on spgemm_csr's ESC route (no tiles)
    # StripArgs, GustavsonPlan, _DenseSched, PairSchedule, ScanPlan,
    # OzakiStripPlan or OzakiPlan
    schedule: object
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


def _download(c_val: torch.Tensor, c_cnt: torch.Tensor):
    """(values f64, occupancy bool) host arrays of device tile planes; the
    counts leave the device as > 0 only."""
    return (c_val.cpu().to(torch.float64).numpy(),
            (c_cnt > 0).cpu().numpy())


def _resolve_backend(a: TileMat, b: TileMat, backend: str, compute_dtype,
                     device: torch.device) -> tuple[str, str]:
    """Pick a feasible tiled route from cheap tile-pointer stats (no slabs
    built), in the JAX package's order: strip, dense (f32 only),
    gustavson, xla. Returns (backend, note).

    The strip gate is the port's own: the strip kernel's instantiated
    (tm, tn) and tk % 8 == 0 on CUDA, any tiles on the CPU (whose plain
    version takes them, as the JAX package's on_cpu does), and float32
    on both (the port's strip route has no f64). The slab (4 GiB) and
    dense (6 GiB) byte gates are the JAX package's. Its SMEM slot-table
    and VMEM gates are TPU limits the port does not carry."""
    f64 = esc.is_f64(compute_dtype)
    acsc_ptr, _ = a.csc_view()
    max_a = max(1, int(np.diff(acsc_ptr).max())) if a.nt else 1
    max_b = max(1, int(np.diff(b.tptr).max())) if b.nt else 1
    tiles_ok = device.type == "cpu" or (
        (a.tm, b.tn) in kernels.SUPPORTED_TILES
        and a.tn % kernels.TK_MULTIPLE == 0)
    strip_ok = tiles_ok and not f64
    # the slab route materializes (gk*max_a*max_b, tm, tn) x2 products
    slab_ok = a.gn * max_a * max_b * a.tm * b.tn * 8 <= SLAB_BYTES
    dense_ok = _dense_bytes(a, b) <= DENSE_BYTES and not f64

    if backend == "auto":
        if strip_ok:
            return "strip", ""
        if dense_ok:
            return "dense", ""
        return ("gustavson" if slab_ok else "xla"), ""
    if backend == "strip" and not strip_ok:
        why = "float64" if tiles_ok else (
            f"no strip kernel for {a.tm}x{b.tn} tiles with tk {a.tn}")
        note = f"strip-fallback: {why}"
        if dense_ok:
            return "dense", note
        return ("gustavson" if slab_ok else "xla"), note
    if backend == "gustavson" and not slab_ok:
        return "xla", "gustavson-fallback: pair products exceed HBM budget"
    return backend, ""


def _dense_bytes(a: TileMat, b: TileMat) -> int:
    """Peak device bytes of the dense route: A/B values f32 + bf16
    occupancy (6 B/elt), C values and counts (8 B/elt), and the tile
    cut's temporaries (about another C)."""
    m_pad, k_pad = a.gm * a.tm, a.gn * a.tn
    n_pad = b.gn * b.tn
    return (m_pad * k_pad + k_pad * n_pad) * 6 + m_pad * n_pad * 16


def _f32_kernel(acc_dtype, kernel: str) -> None:
    """The strip and pair kernels accumulate in float32 only."""
    if acc_dtype is not None and acc_dtype != torch.float32:
        raise ValueError(f"the {kernel} kernel accumulates in float32; "
                         f"acc_dtype={acc_dtype} needs backend 'gustavson', "
                         "'dense' or 'xla'")


def spgemm(a: TileMat, b: TileMat, *, compute_dtype=torch.float32,
           acc_dtype=None, chunk: int = DEFAULT_CHUNK, backend: str = "auto",
           device=None, sync: bool = True) -> SpGEMMResult:
    """Sparse C = A @ B on the tiled format. `device` None means CUDA.

    backend:
      "auto"      the strip kernel where it runs (f32, and on CUDA the
                  tiles it is built for), else "dense" (f32) within its
                  byte budget, else "gustavson" within its, else "xla";
      "strip"     the strip kernel; falls back as "auto" does where it
                  cannot run (the note lands in stats["backend"]);
      "gustavson" batched slab products grouped by the inner tile index
                  plus one scatter (torch ops; "xla" past its budget);
      "dense"     one padded dense matmul and a device tile selection;
      "xla"       pair gather + `bmm` + scatter, `chunk` pairs at a time;
      "pallas"    the per-C-tile pair kernel (f32);
      "esc"       the ESC scan route through CSR, C re-tiled;
      "ozaki"     exact f64 through int8 slices (whatever compute_dtype).

    acc_dtype (None: compute_dtype) is the accumulator of the torch-op
    routes; the strip and pair kernels take float32 only. sync=False
    skips the synchronize that ends the numeric phase."""
    if backend == "ozaki":
        return spgemm_ozaki(a, b, device=device, sync=sync)
    f64 = esc.is_f64(compute_dtype)
    dev = resolve_device(device)
    if backend == "esc":
        return _spgemm_tiles_esc(a, b, f64=f64, device=dev)
    note = ""
    if backend in ("auto", "strip", "gustavson"):
        backend, note = _resolve_backend(a, b, backend, compute_dtype, dev)
    if backend == "strip":
        _f32_kernel(acc_dtype, "strip")
        return _spgemm_strip(a, b, device=dev)
    if backend == "gustavson":
        return _spgemm_gustavson(a, b, f64=f64, acc_dtype=acc_dtype,
                                 device=dev, sync=sync, note=note)
    if backend == "dense":
        return _spgemm_dense(a, b, f64=f64, acc_dtype=acc_dtype, device=dev,
                             note=note)
    if backend in ("pallas", "xla"):
        return _spgemm_pairs(a, b, backend=backend, f64=f64, device=dev,
                             acc_dtype=acc_dtype, chunk=chunk, sync=sync,
                             note=note)
    raise ValueError(f"unknown backend {backend!r}")


def _with_note(name: str, note: str) -> str:
    return f"{name}({note})" if note else name


def _spgemm_pairs(a: TileMat, b: TileMat, *, backend: str, f64: bool,
                  device, acc_dtype=None, chunk: int = DEFAULT_CHUNK,
                  sync: bool = True, note: str = "") -> SpGEMMResult:
    """The pair backends (`spgemm_tpu/ops/spgemm.py:292-355`): schedule,
    upload of the dense and occupancy planes, numeric, compaction."""
    if backend == "pallas":
        pair_kernels.check_pair_dtype(torch.float64 if f64 else torch.float32)
        _f32_kernel(acc_dtype, "pair")
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
            num_segments=sched.nt_c, chunk=chunk, acc_dtype=acc_dtype)
    if sync:
        _sync(device)
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c = _compact_to_tilemat(sched.ctrow, sched.ctcol,
                            *_download(c_val_d, c_cnt_d), (a.m, b.n), a.tm,
                            b.tn)
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3
    stats = {
        "num_pairs": float(sched.num_pairs),
        "numblkC_candidate": float(sched.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": _with_note(backend, note),
    }
    return SpGEMMResult(c=c, schedule=sched, timings_ms=timings, stats=stats)


def _spgemm_gustavson(a: TileMat, b: TileMat, *, f64: bool, acc_dtype,
                      device, sync: bool, note: str) -> SpGEMMResult:
    """The slab route (`spgemm_tpu/ops/spgemm.py:358-475` without its strip
    branch, which is _spgemm_strip): plan, upload, one batched slab step
    and its scatter, compaction."""
    timings: dict[str, float] = {}
    plan = build_gustavson_plan(a, b,
                                dtype=np.float64 if f64 else np.float32)
    timings["prep_ms"] = plan.prep_ms
    timings["symbolic_ms"] = plan.symbolic_ms

    t0 = time.perf_counter()
    ops = plan.to_device(device)
    _sync(device)
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c_val, c_cnt = gustavson_numeric(*ops, **plan.numeric_kwargs(),
                                     acc_dtype=acc_dtype)
    if sync:
        _sync(device)
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    t0 = time.perf_counter()
    c = _compact_to_tilemat(plan.ctrow, plan.ctcol,
                            *_download(c_val, c_cnt), (a.m, b.n), a.tm, b.tn)
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3
    stats = {
        "num_pairs": float(plan.num_pairs),
        "numblkC_candidate": float(plan.nt_c),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": _with_note("gustavson", note),
        "padding_ratio": plan.padding_ratio(),
    }
    return SpGEMMResult(c=c, schedule=plan, timings_ms=timings, stats=stats)


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


# --- dense route ---------------------------------------------------------------
# Where tiling is defeated, one padded dense matmul beats sparse gathering
# up to a large n: the JAX package's replacement for the reference's
# nsparse hash path.

@dataclasses.dataclass
class _DenseSched:
    """Minimal schedule view (ctrow/ctcol/counts) for compaction/stats."""

    ctrow: np.ndarray
    ctcol: np.ndarray
    nt_c: int
    num_pairs: int


def _dense_step(ad, ao, bd, bo, *, gm: int, gn: int, tm: int, tn: int,
                acc_dtype=None):
    """One dense pass: values (a full-FP32 or f64 matmul, accumulated in
    acc_dtype), structural counts (a bf16 0/1 matmul, read only as > 0),
    both cut into (gm, gn, tm, tn) tile views, and the (gm, gn) mask of
    tiles that hold a structural nonzero."""
    acc = acc_dtype or ad.dtype
    mm = product_dtype(ad.dtype, acc)
    with full_fp32():
        cv = torch.matmul(ad.to(mm), bd.to(mm)).to(acc)
    cc = torch.matmul(ao, bo)
    cv4 = cv.view(gm, tm, gn, tn).permute(0, 2, 1, 3)
    cc4 = cc.view(gm, tm, gn, tn).permute(0, 2, 1, 3)
    return cv4, cc4, cc4.amax(dim=(2, 3)) > 0


def _dense_operands(a: TileMat, b: TileMat, np_dt, device):
    """(ad, ao, bd, bo) on `device`: the padded dense values and the
    structural occupancy as bf16 0/1 (explicit zeros are structural)."""
    up = lambda v: torch.from_numpy(v).to(device)
    return (up(a.to_dense_padded(np_dt)),
            up(a.occ_dense_padded()).to(torch.bfloat16),
            up(b.to_dense_padded(np_dt)),
            up(b.occ_dense_padded()).to(torch.bfloat16))


def _spgemm_dense(a: TileMat, b: TileMat, *, f64: bool, acc_dtype, device,
                  note: str = "") -> SpGEMMResult:
    """The dense route (`spgemm_tpu/ops/spgemm.py:778-838`): upload, one
    dense step, one host sync for the tile mask, a gather of the occupied
    tiles on the device, download, compaction. f64 multiplies in f64."""
    timings: dict[str, float] = {}
    gm, gn, tm, tn = a.gm, b.gn, a.tm, b.tn
    t0 = time.perf_counter()
    ops = _dense_operands(a, b, np.float64 if f64 else np.float32, device)
    _sync(device)
    timings["upload_ms"] = (time.perf_counter() - t0) * 1e3
    timings["symbolic_ms"] = 0.0  # the pattern rides the count matmul

    t0 = time.perf_counter()
    cv4, cc4, tile_occ = _dense_step(*ops, gm=gm, gn=gn, tm=tm, tn=tn,
                                     acc_dtype=acc_dtype)
    flat = torch.nonzero(tile_occ.reshape(-1)).squeeze(1)  # host sync
    rows, cols = flat // gn, flat % gn
    c_val, c_occ = _download(cv4[rows, cols], cc4[rows, cols])
    timings["numeric_ms"] = (time.perf_counter() - t0) * 1e3

    ctrow = rows.cpu().numpy().astype(INDEX_DTYPE)
    ctcol = cols.cpu().numpy().astype(INDEX_DTYPE)
    t0 = time.perf_counter()
    c = _compact_to_tilemat(ctrow, ctcol, c_val, c_occ, (a.m, b.n), tm, tn)
    timings["compact_ms"] = (time.perf_counter() - t0) * 1e3

    bptr = b.tptr.astype(np.int64)
    num_pairs = int((bptr[a.tcol + 1] - bptr[a.tcol]).sum()) if a.nt else 0
    sched = _DenseSched(ctrow=ctrow, ctcol=ctcol, nt_c=int(ctrow.size),
                        num_pairs=num_pairs)
    stats = {
        "num_pairs": float(num_pairs),
        "numblkC_candidate": float(ctrow.size),
        "numblkC": float(c.nt),
        "nnzC": float(c.nnz),
        "backend": _with_note("dense", note),
    }
    return SpGEMMResult(c=c, schedule=sched, timings_ms=timings, stats=stats)


def time_dense(a: TileMat, b: TileMat, *, compute_dtype=torch.float32,
               warmup: int = 3, iters: int = 20, device=None) -> float:
    """Median device milliseconds of one dense step (values, counts and
    tile mask; CUDA events around each step after `warmup` untimed ones)
    on operands uploaded once."""
    np_dt = np.float64 if esc.is_f64(compute_dtype) else np.float32
    ops = _dense_operands(a, b, np_dt, resolve_device(device))
    kw = dict(gm=a.gm, gn=b.gn, tm=a.tm, tn=b.tn)
    return cuda_event_ms(lambda: _dense_step(*ops, **kw), warmup=warmup,
                         iters=iters)


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
               compute_dtype=torch.float32, acc_dtype=None,
               chunk: int = DEFAULT_CHUNK, device=None,
               sync: bool = True) -> tuple[CSR, SpGEMMResult]:
    """CSR-level API: C = A @ B with B as A (A^2), A^T (aat) or an
    explicit matrix, on `device` (None means CUDA). Returns CSR C with the
    result record. Any tiles run: the default 16x128 is the strip
    kernel's; TileSpGEMM's 16x16 takes the dense or slab route.

    backend "auto" keeps the JAX package's router: unstructured patterns
    go to the ESC scan route (no tiling), the rest to spgemm's tiled
    router. Any other backend is spgemm's (acc_dtype, chunk and sync go
    there too), "esc" the ESC route. compute_dtype float64 follows the
    JAX package's f64 routing: integer data whose f32 sums are exact
    takes the f32 route; otherwise structured patterns run the Ozaki
    route (strict: OzakiOverflow sends them on), and the rest, like
    backend "esc", the double-double scan."""
    f64 = esc.is_f64(compute_dtype)
    if backend == "esc":
        return _spgemm_csr_esc(a, b, aat=aat, f64=f64, device=device)
    kw = dict(acc_dtype=acc_dtype, chunk=chunk, device=device, sync=sync)
    if backend == "auto":
        if f64:
            if _f32_exact_for(a, b, aat):
                c, res = spgemm_csr(a, b, tm=tm, tn=tn, aat=aat,
                                    compute_dtype=torch.float32, **kw)
                res.stats["backend"] = f"{res.stats['backend']}(f64-exact-int)"
                return c, res
            if tile_occupancy_estimate(a, tm, tn) >= ESC_OCCUPANCY_TH:
                try:
                    return _spgemm_csr_tiled_f64(a, b, aat=aat, tm=tm, tn=tn,
                                                 device=device, sync=sync)
                except OzakiOverflow:
                    pass
            return _spgemm_csr_esc(a, b, aat=aat, f64=True, device=device)
        occ = tile_occupancy_estimate(a, tm, tn)
        if occ < ESC_OCCUPANCY_TH or (
                occ < ESC_STRUCTURED_OCC_TH
                and _mxu_reuse(a, b, aat) < ESC_REUSE_TH):
            return _spgemm_csr_esc(a, b, aat=aat, f64=False, device=device)
    at = csr_to_tiles(a, tm, tn)
    # inner blocking must agree: A tiles (tm, tn) -> B tiles (tn, tn)
    bt = _tile_b_role(a, b, at, aat, tm, tn)
    res = spgemm(at, bt, backend=backend, compute_dtype=compute_dtype, **kw)
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
                          tn: int, device,
                          sync: bool) -> tuple[CSR, SpGEMMResult]:
    """Structured-f64 branch of spgemm_csr: tile, then the Ozaki route
    with strict=True, so data whose per-row significand span is far
    beyond the slice window raises OzakiOverflow and the caller runs the
    double-double scan. Raises OzakiOverflow when the int32 accumulation
    bound fails too."""
    at = csr_to_tiles(a, tm, tn)
    bt = _tile_b_role(a, b, at, aat, tm, tn)
    res = spgemm_ozaki(at, bt, device=device, sync=sync, strict=True)
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
