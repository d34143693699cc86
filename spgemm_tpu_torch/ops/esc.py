"""ESC scan engine for unstructured matrices (port of the scan half of
`spgemm_tpu/ops/esc.py`).

Host symbolic (pattern-static, reusable): expand the nnzCub partial
products, sort them by their destination in C's value array, and lay
each 128-slot window's products out as (R, 128) lane rows, with an int32
meta plane of run marks (`build_esc_scan_plan`, native `esc_scan_build`
with a NumPy fallback). Device numeric: the scan kernels of
ops/scan_kernels.py (a log-doubling segmented suffix scan along the
lanes, a gather of each run's sum, an in-kernel G-row sum), then the
window combine as torch ops (row gathers plus reshape-sums), then a small
host epilogue that finishes windows taller than COMBINE_K rows in f64.

f64 runs the double-double kernel on (hi, lo) f32 planes of the exact
products. The JAX package's SPGEMM_META16 and SPGEMM_DEVICE_COMBINE
switches are not carried: the device always gets the int16 meta plane and
the combine always runs on the device.

The digit mode (`EscPlan`, `build_esc_plan`, `esc_digit_reduce`) is the
portable formulation: C's value array is cut into groups of S_SLOTS = 2048
slots, each group's products are laid out as padded (G, W) operand
streams with a slot id each, and the device contracts
``out[g, h, a] = sum_w (hi==h) * (lo==a) * av*bv`` as a batched one-hot
matmul (hi = slot >> 5, lo = slot & 31). The reference runs it as an XLA
`dot_general`, so here it is torch ops (`bmm` in full FP32, or float64),
with no hand kernel. Padding products carry av = 0 and add exactly 0.
`spgemm_esc` runs it for mode="digit" or an EscPlan.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgemm_tpu_torch.models.csr import CSR, INDEX_DTYPE
from spgemm_tpu_torch.ops import scan_kernels
from spgemm_tpu_torch.ops.gustavson import full_fp32
from spgemm_tpu_torch.utils.timing import (count_bytes, cuda_event_ms,
                                           profiler_device_ms, resolve_device,
                                           span)

SCAN_WIN = 128
SCAN_BLK = 2048   # plans pad R to a multiple of this many rows
COMBINE_K = 32    # windows taller than this (in output rows) take the tail

S_SLOTS = 2048            # digit mode: slot positions per group (64 * 32)
HI_W, LO_W = 64, 32
W_MIN, W_MAX = 256, 4096  # product-stream width classes
# device bytes the digit contraction's temporaries may take per chunk of
# groups: the (G, W, 32) masked products, the (G, W, 64) one-hot and their
# masks take ~9 GB at random65536 unchunked
DIGIT_BYTES = 1 << 30


def _expand_products(a: CSR, b: CSR):
    """All nnzCub partial products in A-order: (a_idx, b_idx, rows, cols)
    int64 arrays."""
    blen = (b.indptr[1:] - b.indptr[:-1]).astype(np.int64)
    counts = blen[a.indices]
    total = int(counts.sum())
    if total == 0:
        e = np.zeros(0, np.int64)
        return e, e, e, e
    a_idx = np.repeat(np.arange(a.nnz, dtype=np.int64), counts)
    rows = np.repeat(a.rows_expanded().astype(np.int64), counts)
    reps = np.repeat(b.indptr[a.indices].astype(np.int64), counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    b_idx = reps + offs
    cols = b.indices[b_idx].astype(np.int64)
    return a_idx, b_idx, rows, cols


def _structural_pattern(a: CSR, b: CSR) -> tuple[np.ndarray, np.ndarray]:
    """C's structural pattern (an entry exists iff any a_ik*b_kj term
    exists, whatever the values) as sorted CSR (indptr, indices)."""
    import scipy.sparse as sp

    sa = sp.csr_matrix(
        (np.ones(a.nnz, np.float64), a.indices, a.indptr), shape=a.shape)
    sb = sp.csr_matrix(
        (np.ones(b.nnz, np.float64), b.indices, b.indptr), shape=b.shape)
    sc = (sa @ sb).tocsr()
    sc.sort_indices()
    return sc.indptr.astype(np.int64), sc.indices.astype(np.int64)


# --- digit mode: host symbolic ------------------------------------------------

@dataclasses.dataclass
class EscPlan:
    """Pattern-static plan of the digit mode: everything the numeric phase
    needs except the input values. `refresh_values` rebuilds the value
    streams for new values under the same pattern (a host gather)."""

    shape: tuple[int, int]
    c_indptr: np.ndarray          # C pattern (structural, sorted cols)
    c_indices: np.ndarray
    nnz_c: int
    num_products: int             # nnzCub
    # per width class: {w, av, bv, slot, base, glen}, streams (G, W)
    classes: list[dict]
    # per class: (G*W,) int32 gather indices into a.data (-1 pad) / b.data
    a_src: list[np.ndarray]
    b_src: list[np.ndarray]
    s_slots: int = S_SLOTS
    symbolic_ms: float = 0.0

    def to_device(self, device, dtype=torch.float32) -> list[dict]:
        """Per class, the operand streams on `device`: av and bv in
        `dtype` (float32 or float64), slot int32, each (G, W)."""
        np_dt = np.float64 if is_f64(dtype) else np.float32
        return [dict(av=torch.from_numpy(cls["av"].astype(np_dt)).to(device),
                     bv=torch.from_numpy(cls["bv"].astype(np_dt)).to(device),
                     slot=torch.from_numpy(cls["slot"]).to(device))
                for cls in self.classes]

    def refresh_values(self, a_data: np.ndarray, b_data: np.ndarray):
        """Rebuild the value streams for new input values under the same
        pattern (host gather, vectorized)."""
        for cls, asrc, bsrc in zip(self.classes, self.a_src, self.b_src):
            g, w = cls["slot"].shape
            av = np.zeros(g * w, np.float64)
            bv = np.zeros(g * w, np.float64)
            ok = asrc >= 0
            av[ok] = a_data[asrc[ok]]
            bv[ok] = b_data[bsrc[ok]]
            cls["av"] = av.reshape(g, w)
            cls["bv"] = bv.reshape(g, w)


def _sibling_layout(prod_cnt: np.ndarray, nnz_c: int, s_slots: int,
                    f_max: int, w_min: int = W_MIN) -> dict:
    """Group layout over fixed S-slot intervals of C's value array.
    Interval g (slots [g*S, (g+1)*S)) receives prod_cnt[g] products; past
    f_max it splits into sibling groups over the same interval (esc_trim
    sums them). Each sibling lands in a width class at 256 granularity;
    returns the flat offsets for the operand-stream fill."""
    n_int = prod_cnt.size
    n_sib = np.maximum(1, -(-prod_cnt // f_max)).astype(np.int64)
    sib_ptr = np.zeros(n_int + 1, np.int64)
    np.cumsum(n_sib, out=sib_ptr[1:])
    total = int(sib_ptr[-1])
    sib_int = np.repeat(np.arange(n_int, dtype=np.int64), n_sib)
    sib_rank = np.arange(total, dtype=np.int64) - sib_ptr[sib_int]
    sib_cnt = np.maximum(
        np.minimum(prod_cnt[sib_int] - sib_rank * f_max, f_max), 1)
    # 256-granular classes: pow2 classes would waste up to 2x padding
    # where an interval's product count sits just above a power of two
    w = np.maximum(w_min, -(-sib_cnt // 256) * 256)
    sib_base = np.zeros(total, np.int64)
    classes = []
    flat_total = 0
    for wv in sorted(set(w.tolist())):
        ids = np.flatnonzero(w == wv)
        sib_base[ids] = flat_total + np.arange(ids.size, dtype=np.int64) * wv
        base = sib_int[ids] * s_slots
        glen = np.minimum(s_slots, nnz_c - base)
        classes.append(dict(w=int(wv), g=int(ids.size),
                            flat_ofs=int(flat_total), base=base, glen=glen))
        flat_total += ids.size * int(wv)
    return dict(classes=classes, sib_ptr=sib_ptr, sib_base=sib_base,
                flat_total=int(flat_total))


def _esc_symbolic_numpy(a: CSR, b: CSR, s_slots: int, f_max: int):
    """NumPy digit-mode symbolic (the same outputs as
    utils/native.py:esc_symbolic_native): pattern via scipy, destinations
    via one global searchsorted, a counting sort into the padded layout."""
    c_indptr, c_indices = _structural_pattern(a, b)
    nnz_c = int(c_indptr[-1])
    n = b.n
    a_idx, b_idx, rows, cols = _expand_products(a, b)
    total = a_idx.size
    n_int = max(1, -(-nnz_c // s_slots))
    prod_cnt = np.zeros(n_int, np.int64)
    dest = gidx = None
    if total:
        c_rows = np.repeat(np.arange(a.m, dtype=np.int64),
                           np.diff(c_indptr).astype(np.int64))
        c_keys = c_rows * n + c_indices
        dest = np.searchsorted(c_keys, rows * n + cols)
        del c_keys, c_rows, rows, cols
        gidx = dest // s_slots
        prod_cnt = np.bincount(gidx, minlength=n_int).astype(np.int64)
    layout = _sibling_layout(prod_cnt, nnz_c, s_slots, f_max)
    asrc = np.full(layout["flat_total"], -1, np.int32)
    bsrc = np.zeros(layout["flat_total"], np.int32)
    slot = np.zeros(layout["flat_total"], np.int32)
    av = np.zeros(layout["flat_total"], np.float64)
    bv = np.zeros(layout["flat_total"], np.float64)
    if total:
        order = np.argsort(gidx, kind="stable")
        gs = gidx[order]
        start = np.zeros(n_int + 1, np.int64)
        np.cumsum(prod_cnt, out=start[1:])
        rank = np.arange(total, dtype=np.int64) - start[gs]
        sib = layout["sib_ptr"][gs] + rank // f_max
        off = layout["sib_base"][sib] + rank % f_max
        asrc[off] = a_idx[order]
        bsrc[off] = b_idx[order]
        slot[off] = (dest[order] - gs * s_slots).astype(np.int32)
        av[off] = a.data[a_idx[order]]
        bv[off] = b.data[b_idx[order]]
    return (c_indptr, c_indices.astype(np.int32), total, prod_cnt,
            asrc, bsrc, slot, layout, av, bv)


def build_esc_plan(a: CSR, b: CSR, *, s_slots: int = S_SLOTS,
                   f_max: int = W_MAX) -> EscPlan:
    """Host symbolic of the digit mode: products -> (group, slot). Native
    C++ (native/csr2tile.cpp esc_* passes) with a NumPy fallback."""
    t: dict[str, float] = {}
    with span("symbolic", t):
        if a.n != b.m:
            raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
        from spgemm_tpu_torch.utils.native import esc_symbolic_native

        res = esc_symbolic_native(a, b, s_slots, f_max, W_MIN)
        if res is None:
            res = _esc_symbolic_numpy(a, b, s_slots, f_max)
        (c_indptr, c_indices, total, _, asrc, bsrc, slot, layout, av, bv) = res
        plan = EscPlan(
            shape=(a.m, b.n), c_indptr=np.asarray(c_indptr, np.int64),
            c_indices=c_indices.astype(INDEX_DTYPE, copy=False),
            nnz_c=int(c_indptr[-1]), num_products=int(total), classes=[],
            a_src=[], b_src=[], s_slots=s_slots,
        )
        for cls in layout["classes"]:
            g, w, o = cls["g"], cls["w"], cls["flat_ofs"]
            plan.classes.append(dict(
                w=w, av=av[o : o + g * w].reshape(g, w),
                bv=bv[o : o + g * w].reshape(g, w),
                slot=slot[o : o + g * w].reshape(g, w),
                base=cls["base"], glen=cls["glen"],
            ))
            plan.a_src.append(asrc[o : o + g * w])
            plan.b_src.append(bsrc[o : o + g * w])
    plan.symbolic_ms = t["symbolic_ms"]
    return plan


def meta16_plane(meta: np.ndarray) -> np.ndarray:
    """The kernels' int16 meta plane from the host's int32 one: bits 0-6
    idx, bit 7 present, bits 8-14 dist (the int32 plane's bits 7-21).
    Values are <= 0x7FFF, so the int16 is non-negative and the kernels'
    widening is a plain sign extension. Computed with torch's
    multi-threaded CPU ops (NumPy's single thread took 1.9 s at
    rmat65536's 494 M lanes)."""
    src = torch.from_numpy(np.ascontiguousarray(meta, np.int32))
    m16 = torch.empty(src.shape, dtype=torch.int16)
    step = 1 << 18  # rows per step: bounds the int32 temporary
    for lo in range(0, src.shape[0], step):
        m16[lo : lo + step] = (src[lo : lo + step] >> 7).bitwise_and_(0x7FFF)
    return m16.numpy()


@dataclasses.dataclass
class ScanPlan:
    """Pattern-static plan for the scan kernels. Rows are (R, 128): row r
    holds 128 consecutive destination-sorted products of one 128-slot
    window of C's value array; win_rowptr[w] is the first row of window w.

    qv carries the host-premultiplied products (the f64 product rounded
    once to f32). meta packs per lane: bits 0-6 slot (dest & 127), bits
    7-13 the run-start lane this slot gathers from, bit 14 slot-present,
    bits 15-21 the distance to the end of this lane's in-row run."""

    shape: tuple[int, int]
    c_indptr: np.ndarray
    c_indices: np.ndarray
    nnz_c: int
    num_products: int
    qv: np.ndarray               # (R, 128) f32
    meta: np.ndarray             # (R, 128) int32 packed
    win_rowptr: np.ndarray       # (n_win + 1,) int64
    a_src: np.ndarray | None     # (R, 128) int32, -1 padding
    b_src: np.ndarray | None     # (None when keep_sources=False)
    passes: int                  # ceil(log2(max in-row run length))
    group_rows: int = 1          # in-kernel G-row window reduction factor
    symbolic_ms: float = 0.0

    def meta16(self) -> np.ndarray:
        """meta16_plane(self.meta), computed once per plan."""
        cached = getattr(self, "_meta16", None)
        if cached is None or cached.shape != self.meta.shape:
            cached = self._meta16 = meta16_plane(self.meta)
        return cached

    def to_device(self, device) -> dict[str, torch.Tensor]:
        """The kernel's operands on `device`: qv float32 and the int16
        meta plane, each (R, 128)."""
        return dict(qv=torch.from_numpy(self.qv).to(device),
                    meta=torch.from_numpy(self.meta16()).to(device))

    def refresh_values(self, a_data: np.ndarray, b_data: np.ndarray):
        """Pattern-fixed value refresh of qv (native fused
        gather-multiply, NumPy fallback)."""
        if self.a_src is None:
            raise ValueError(
                "plan built with keep_sources=False cannot refresh")
        self.qv = refresh_qv(self, a_data, b_data, out=self.qv)


def refresh_qv(plan: ScanPlan, a_data, b_data, out=None) -> np.ndarray:
    """The premultiplied plane for new values under plan's pattern:
    f32(a*b) per product lane, 0 on padding lanes. Writes into `out` when
    given (the native path), else returns a new array."""
    from spgemm_tpu_torch.utils.native import esc_refresh_qv_native

    res = esc_refresh_qv_native(plan.a_src, plan.b_src, a_data, b_data,
                                out=out)
    if res is not None:
        return res
    ok = plan.a_src >= 0
    return (np.where(ok, a_data[np.maximum(plan.a_src, 0)], 0.0)
            * np.where(ok, b_data[np.maximum(plan.b_src, 0)], 0.0)
            ).astype(np.float32)


def gather_planes(plan: ScanPlan, a_data, b_data):
    """Separate (av, bv) f32 planes for the in-kernel-multiply kernel."""
    from spgemm_tpu_torch.utils.native import esc_gather_planes_native

    res = esc_gather_planes_native(plan.a_src, plan.b_src, a_data, b_data)
    if res is not None:
        return res
    ok = plan.a_src >= 0
    av = np.where(ok, a_data[np.maximum(plan.a_src, 0)], 0.0)
    bv = np.where(ok, b_data[np.maximum(plan.b_src, 0)], 0.0)
    return av.astype(np.float32), bv.astype(np.float32)


def build_esc_scan_plan(a: CSR, b: CSR, *, keep_sources: bool = True,
                        group_rows: int = 1) -> ScanPlan:
    """Host symbolic for the scan route: native esc_scan_build with a
    vectorized NumPy fallback. keep_sources=False skips the a_src/b_src
    maps (the plan then cannot refresh values or run the double-double
    route). group_rows=G pads every window's row count to a multiple of
    G; the kernels then emit one sum per G rows (see choose_group_rows)."""
    t: dict[str, float] = {}
    with span("symbolic", t):
        if a.n != b.m:
            raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
        if group_rows not in (1, 2, 4, 8):
            raise ValueError(f"group_rows must be 1, 2, 4 or 8: {group_rows}")
        from spgemm_tpu_torch.utils.native import esc_scan_symbolic_native

        res = esc_scan_symbolic_native(a, b, keep_sources=keep_sources,
                                       group_rows=group_rows)
        if res is None:
            res = _esc_scan_symbolic_numpy(a, b, group_rows=group_rows)
        (c_indptr, c_indices, total, qv, meta,
         win_rowptr, asrc, bsrc, max_run) = res
        plan = ScanPlan(
            shape=(a.m, b.n), c_indptr=np.asarray(c_indptr, np.int64),
            c_indices=c_indices.astype(INDEX_DTYPE, copy=False),
            nnz_c=int(c_indptr[-1]), num_products=int(total),
            qv=qv, meta=meta, win_rowptr=win_rowptr, a_src=asrc, b_src=bsrc,
            passes=max(0, int(max_run - 1).bit_length()),
            group_rows=group_rows,
        )
    plan.symbolic_ms = t["symbolic_ms"]
    return plan


def _esc_scan_symbolic_numpy(a: CSR, b: CSR, group_rows: int = 1):
    """NumPy scan-mode symbolic: a global stable argsort by destination is
    the counting sort; everything else is layout arithmetic."""
    c_indptr, c_indices = _structural_pattern(a, b)
    nnz_c = int(c_indptr[-1])
    n = b.n
    a_idx, b_idx, rows, cols = _expand_products(a, b)
    total = a_idx.size
    n_win = max(1, -(-nnz_c // SCAN_WIN))
    if total == 0:
        # every plan is SCAN_BLK-padded, the empty one included
        zf = np.zeros((SCAN_BLK, SCAN_WIN), np.float32)
        zi = np.zeros((SCAN_BLK, SCAN_WIN), np.int32)
        return (c_indptr, c_indices.astype(np.int32), 0, zf, zi,
                np.zeros(n_win + 1, np.int64), zi, zi, 1)
    c_rows = np.repeat(np.arange(a.m, dtype=np.int64),
                       np.diff(c_indptr).astype(np.int64))
    c_keys = c_rows * n + c_indices
    dest = np.searchsorted(c_keys, rows * n + cols)
    del c_keys, c_rows, rows, cols

    order = np.argsort(dest, kind="stable")
    ds = dest[order]
    win = ds >> 7
    wcnt = np.bincount(win, minlength=n_win).astype(np.int64)
    wrows = np.maximum(1, -(-wcnt // SCAN_WIN))
    wrows = -(-wrows // group_rows) * group_rows
    win_rowptr = np.zeros(n_win + 1, np.int64)
    np.cumsum(wrows, out=win_rowptr[1:])
    r_total = -(-int(win_rowptr[-1]) // SCAN_BLK) * SCAN_BLK
    padbase = win_rowptr[:-1] * SCAN_WIN
    start = np.zeros(n_win + 1, np.int64)
    np.cumsum(wcnt, out=start[1:])
    pos = padbase[win] + (np.arange(total, dtype=np.int64) - start[win])
    prow, plane = pos >> 7, (pos & 127).astype(np.int64)

    qv = np.zeros((r_total, SCAN_WIN), np.float32)
    meta = np.zeros((r_total, SCAN_WIN), np.int32)
    asrc = np.full((r_total, SCAN_WIN), -1, np.int32)
    bsrc = np.zeros((r_total, SCAN_WIN), np.int32)
    # in-row run segments: first product of each (row, dest) pair
    fir = np.concatenate(([True], (ds[1:] != ds[:-1])
                          | (prow[1:] != prow[:-1])))
    starts_pos = np.flatnonzero(fir)
    runlen = np.diff(np.append(starts_pos, total))
    run_id = np.cumsum(fir) - 1
    rel = np.arange(total, dtype=np.int64) - starts_pos[run_id]
    # distance to the end of this lane's in-row run (meta bits 15-21): the
    # kernels mask each doubling step with one compare
    dist = np.minimum(runlen[run_id] - 1 - rel, 127 - plane)
    qv[prow, plane] = (a.data[a_idx[order]]
                       * b.data[b_idx[order]]).astype(np.float32)
    meta[prow, plane] = ((ds & 127) | (dist << 15)).astype(np.int32)
    asrc[prow, plane] = a_idx[order].astype(np.int32)
    bsrc[prow, plane] = b_idx[order].astype(np.int32)
    meta[prow[fir], (ds[fir] & 127)] |= (
        (plane[fir].astype(np.int32) << 7) | (1 << 14))
    max_run = int(runlen.max()) if runlen.size else 1
    return (c_indptr, c_indices.astype(np.int32), total, qv, meta,
            win_rowptr, asrc, bsrc, max_run)


def choose_group_rows(a: CSR, b: CSR, sample_rows: int = 2048) -> int:
    """The plan's in-kernel window-reduction factor, from a sampled
    duplication estimate: windows average ~dup rows, so G=8 pays when dup
    is large (structured inputs) and G=1 when windows are thin (rmat:
    padding would blow the layout up)."""
    m = a.m
    if m == 0 or a.nnz == 0 or b.nnz == 0:
        return 1
    lo = max(0, m // 2 - sample_rows // 2)
    hi = min(m, lo + sample_rows)
    sub = CSR(a.indptr[lo : hi + 1] - a.indptr[lo],
              a.indices[a.indptr[lo] : a.indptr[hi]],
              a.data[a.indptr[lo] : a.indptr[hi]], (hi - lo, a.n))
    c_ip, _ = _structural_pattern(sub, b)
    nnz_sample = int(c_ip[-1])
    if nnz_sample == 0:
        return 1
    blen = (b.indptr[1:] - b.indptr[:-1]).astype(np.int64)
    f_sample = int(blen[sub.indices].sum())
    dup = f_sample / nnz_sample
    if dup >= 16.0:
        return 8
    if dup >= 8.0:
        return 4
    if dup >= 4.0:
        return 2
    return 1


# --- numeric ---------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def esc_scan_numeric(plan: ScanPlan, dev: dict | None = None, *,
                     device=None) -> torch.Tensor:
    """The scan kernel on the plan's planes (uploaded to `device` unless
    `dev` holds them already). Returns the (R/G, 128) output tensor."""
    if dev is None:
        dev = plan.to_device(resolve_device(device))
    return scan_kernels.esc_scan(dev["qv"], dev["meta"], passes=plan.passes,
                                 group_rows=plan.group_rows)


def esc_scan_trim(plan: ScanPlan, out) -> CSR:
    """Host trim: the rows of one window are siblings, so one reduceat (in
    f64) sums them; the window-major flattening is C's value order. The
    tests' check of the device combine."""
    c_val = np.zeros(plan.nnz_c, np.float64)
    if plan.nnz_c:
        arr = _host_f64(out)
        sums = np.add.reduceat(
            arr, plan.win_rowptr[:-1] // plan.group_rows, axis=0)
        c_val[:] = sums.reshape(-1)[: plan.nnz_c]
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


def _host_f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.asarray(t, np.float64)


# --- device window combine ---------------------------------------------------
# The kernel output has R/G rows, dup/fill times more than C itself. The
# combine reduces each window's sibling rows on the device: windows are
# grouped by row count k <= COMBINE_K, each class is one row gather plus a
# reshape-sum, and a last row gather puts the sums in window order, so the
# download carries ~4*nnzC bytes. Taller windows are summed in COMBINE_K-row
# chunks on the device and finished on the host in f64.

def _combine_host_layout(plan: ScanPlan):
    """Plan-static host half of the combine layout (computed once):
    (classes [(k, row indices)], perm, sentinel tail rows, tsel, tail_ptr)."""
    cached = getattr(plan, "_combine_host", None)
    if cached is not None:
        return cached
    g = plan.group_rows
    start = (plan.win_rowptr[:-1] // g).astype(np.int64)
    wr = (np.diff(plan.win_rowptr) // g).astype(np.int64)
    n_win = wr.size
    main = wr <= COMBINE_K
    classes = []
    perm = np.empty(n_win, np.int64)
    base = 0
    for k in np.unique(wr[main]):
        if k == 0:
            continue  # empty-plan windows read the appended zero row
        wsel = np.flatnonzero(wr == k)
        rows = (start[wsel][:, None]
                + np.arange(k, dtype=np.int64)[None, :]).reshape(-1)
        classes.append((int(k), rows))
        perm[wsel] = base + np.arange(wsel.size)
        base += wsel.size
    perm[wr == 0] = base
    tsel = np.flatnonzero(~main)
    tail_idx = np.zeros(0, np.int64)
    tail_ptr = np.zeros(1, np.int64)
    if tsel.size:
        # each tall window in COMBINE_K-row pieces; the last piece is
        # padded with a sentinel row (index R/G: an appended zero row)
        n_chunks = -(-wr[tsel] // COMBINE_K)
        tail_ptr = np.zeros(tsel.size + 1, np.int64)
        np.cumsum(n_chunks, out=tail_ptr[1:])
        rows = []
        for w, nc in zip(tsel, n_chunks):
            r = np.arange(nc * COMBINE_K, dtype=np.int64) + start[w]
            r[wr[w]:] = -1
            rows.append(r)
        tail_idx = np.concatenate(rows)
        perm[tsel] = base  # the zero row; the host fills these windows
    r_out = plan.qv.shape[0] // g
    sent = np.where(tail_idx < 0, r_out, tail_idx)
    layout = (classes, perm, sent, tsel, tail_ptr)
    plan._combine_host = layout
    return layout


def _combine_layout(plan: ScanPlan, device: torch.device):
    """The combine's index tensors on `device`, uploaded once per plan and
    device (a plan used on the CPU and then on a card never mixes
    tensors). Returns (class list [(k, idx)], perm, sentinel idx or None)."""
    cache = plan.__dict__.setdefault("_combine_dev", {})
    key = str(device)
    if key not in cache:
        classes, perm, sent, _, _ = _combine_host_layout(plan)
        cache[key] = (
            [(k, torch.from_numpy(ii).to(device)) for k, ii in classes],
            torch.from_numpy(perm).to(device),
            torch.from_numpy(sent).to(device) if sent.size else None)
    return cache[key]


def _combine_apply(plan: ScanPlan, out: torch.Tensor):
    """(R/G, 128) kernel output -> ((n_win, 128) window sums with tall
    windows zeroed, (n_tail_chunks, 128) tail partials or None)."""
    classes, perm, sent = _combine_layout(plan, out.device)
    wn = out.shape[1]
    zero = out.new_zeros(1, wn)
    parts = [out.index_select(0, ii).view(-1, k, wn).sum(dim=1)
             for k, ii in classes]
    res = torch.cat(parts + [zero]).index_select(0, perm)
    tail = None
    if sent is not None:
        tail = (torch.cat([out, zero]).index_select(0, sent)
                .view(-1, COMBINE_K, wn).sum(dim=1))
    return res, tail


def _two_sum_rows(ss: torch.Tensor, ee: torch.Tensor):
    """Compensated left-to-right sum over dim 1 of (n, k, 128) (s, e)
    blocks: the kernel's 2Sum, so the double-double bound survives."""
    sa, ea = ss[:, 0], ee[:, 0]
    for j in range(1, ss.shape[1]):
        sa, ea = scan_kernels.two_sum_acc(sa, ea, ss[:, j], ee[:, j])
    return sa, ea


def _combine_apply_dd(plan: ScanPlan, s: torch.Tensor, e: torch.Tensor):
    """Compensated device combine of the double-double planes."""
    classes, perm, sent = _combine_layout(plan, s.device)
    wn = s.shape[1]
    zero = s.new_zeros(1, wn)
    parts_s, parts_e = [], []
    for k, ii in classes:
        sa, ea = _two_sum_rows(s.index_select(0, ii).view(-1, k, wn),
                               e.index_select(0, ii).view(-1, k, wn))
        parts_s.append(sa)
        parts_e.append(ea)
    res = (torch.cat(parts_s + [zero]).index_select(0, perm),
           torch.cat(parts_e + [zero]).index_select(0, perm))
    tail = None
    if sent is not None:
        tail = _two_sum_rows(
            torch.cat([s, zero]).index_select(0, sent)
            .view(-1, COMBINE_K, wn),
            torch.cat([e, zero]).index_select(0, sent)
            .view(-1, COMBINE_K, wn))
    return res, tail


def esc_scan_numeric_combined(plan: ScanPlan, dev: dict | None = None, *,
                              device=None):
    """Scan kernel + device window combine. Returns (res, tail) tensors
    for esc_scan_trim_combined."""
    out = esc_scan_numeric(plan, dev, device=device)
    return _combine_apply(plan, out)


def _finish(plan: ScanPlan, arr: np.ndarray, tail: np.ndarray | None) -> CSR:
    """C from the f64 window sums (n_win, 128) and tail chunk sums."""
    if tail is not None:
        _, _, _, tsel, tail_ptr = _combine_host_layout(plan)
        arr[tsel] = np.add.reduceat(tail, tail_ptr[:-1], axis=0)
    c_val = arr.reshape(-1)[: plan.nnz_c].copy()
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


def esc_scan_trim_combined(plan: ScanPlan, res, tail,
                           into: dict | None = None,
                           moved: dict | None = None) -> CSR:
    """Host epilogue of the device combine: download the (n_win, 128)
    window sums (~4*nnzC bytes), finish tall windows in f64. `into` (a
    timings dict) gets download_ms: the copies and their f64 conversion;
    `moved` the d2h_bytes (utils/timing.py:count_bytes)."""
    if isinstance(res, torch.Tensor):
        count_bytes(moved, "d2h_bytes", res, tail)
    with span("download", into):
        arr = _host_f64(res)
        tl = None if tail is None else _host_f64(tail)
    return _finish(plan, arr, tl)


def esc_scan_trim_combined_dd(plan: ScanPlan, res, tail) -> CSR:
    """Host epilogue of the DD device combine: f64(s) + f64(e) per window;
    tall windows finished from their compensated chunk pairs."""
    return _finish(plan, _host_f64(res[0]) + _host_f64(res[1]),
                   None if tail is None
                   else _host_f64(tail[0]) + _host_f64(tail[1]))


# --- double-double (f64) -----------------------------------------------------

def scan_dd_planes(plan: ScanPlan, a_data, b_data):
    """Host: the exact f64 products split into (hi, lo) f32 planes for the
    double-double kernel. Needs a plan built with keep_sources=True."""
    if plan.a_src is None:
        raise ValueError(
            "double-double needs a plan built with keep_sources=True")
    if a_data is None or b_data is None:
        raise ValueError("scan_dd_planes needs a_data and b_data")
    from spgemm_tpu_torch.utils.native import esc_refresh_dd_native

    res = esc_refresh_dd_native(plan.a_src, plan.b_src, a_data, b_data)
    if res is not None:
        return res
    ok = plan.a_src >= 0
    p = np.where(ok, a_data[np.maximum(plan.a_src, 0)]
                 * b_data[np.maximum(plan.b_src, 0)], 0.0)
    hi = p.astype(np.float32)
    lo = (p - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def esc_scan_dd(plan: ScanPlan, a_data: np.ndarray, b_data: np.ndarray,
                *, device=None) -> CSR:
    """f64-accurate C through the double-double scan kernel and the
    compensated device combine; values accurate to ~1e-14 relative."""
    dev = resolve_device(device)
    hi, lo = scan_dd_planes(plan, a_data, b_data)
    s, e = scan_kernels.esc_scan_dd(
        torch.from_numpy(hi).to(dev), torch.from_numpy(lo).to(dev),
        torch.from_numpy(plan.meta16()).to(dev), passes=plan.passes,
        group_rows=plan.group_rows)
    res, tail = _combine_apply_dd(plan, s, e)
    return esc_scan_trim_combined_dd(plan, res, tail)


def _resident_dd_launch(plan: ScanPlan, a_data, b_data):
    """One double-double scan launch on (hi, lo, meta) planes of these
    values uploaded to the card once, as a zero-argument callable. Raises
    without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the double-double scan timers need a CUDA device")
    dev = torch.device("cuda")
    qh, ql = (torch.from_numpy(p).to(dev)
              for p in scan_dd_planes(plan, a_data, b_data))
    meta = torch.from_numpy(plan.meta16()).to(dev)
    return lambda: scan_kernels.esc_scan_dd(
        qh, ql, meta, passes=plan.passes, group_rows=plan.group_rows)


def time_esc_scan_dd(plan: ScanPlan, a_data, b_data, *, warmup: int = 3,
                     iters: int = 20) -> float:
    """Median device ms of one double-double scan-kernel launch on
    resident planes of these values, by CUDA events. Raises without a
    card."""
    return cuda_event_ms(_resident_dd_launch(plan, a_data, b_data),
                         warmup=warmup, iters=iters)


def device_ms_esc_scan_dd(plan: ScanPlan, a_data, b_data, *,
                          iters: int = 20) -> float:
    """The same launch's device time from torch.profiler (the kernel's
    own duration, per launch). The kernel is short (≈0.1 ms at
    random65536), near the host's launch overhead, so its events time
    can include the card waiting for the host. Raises without a card."""
    return profiler_device_ms(_resident_dd_launch(plan, a_data, b_data),
                              iters=iters)


# --- digit mode: numeric ---------------------------------------------------------

def esc_digit_reduce(av: torch.Tensor, bv: torch.Tensor, slot: torch.Tensor,
                     *, s_slots: int = S_SLOTS,
                     budget_bytes: int = DIGIT_BYTES) -> torch.Tensor:
    """The digit contraction: out[g, slot] = sum over products w of
    av*bv where slot matches, for (G, W) streams; returns (G, s_slots) in
    av's dtype. A batched one-hot `bmm` (hi digit one-hot against the
    lo-masked products) in full FP32 (TF32 off) or float64, over chunks of
    groups whose temporaries fit `budget_bytes`; each group's sum is
    independent of the chunking."""
    lo_w = min(LO_W, s_slots)
    hi_w = s_slots // lo_w
    shift = lo_w.bit_length() - 1
    g_n, w = av.shape
    out = torch.empty(g_n, hi_w, lo_w, dtype=av.dtype, device=av.device)
    # per product: the masked products, the one-hot and their bool masks
    per_group = w * ((hi_w + lo_w) * (av.element_size() + 1)
                     + 2 * av.element_size())
    chunk = max(1, budget_bytes // max(1, per_group))
    lo_iota = torch.arange(lo_w, dtype=slot.dtype, device=slot.device)
    hi_iota = torch.arange(hi_w, dtype=slot.dtype, device=slot.device)
    with full_fp32():
        for g0 in range(0, g_n, chunk):
            sl = slice(g0, g0 + chunk)
            q = av[sl] * bv[sl]                                  # (g, W)
            s = slot[sl]
            u = torch.where((s & (lo_w - 1))[:, :, None] == lo_iota,
                            q[:, :, None], 0.0)                  # (g, W, lo)
            ohh = ((s >> shift)[:, :, None] == hi_iota).to(av.dtype)
            torch.bmm(ohh.transpose(1, 2), u, out=out[sl])       # (g, hi, lo)
            del q, u, ohh
    return out.view(g_n, s_slots)


def esc_numeric(plan: EscPlan, dev_arrays: list[dict] | None = None, *,
                dtype=torch.float32, device=None,
                budget_bytes: int = DIGIT_BYTES) -> list[torch.Tensor]:
    """The digit mode's numeric phase on the plan's streams (uploaded to
    `device` unless `dev_arrays` holds them): the list of padded
    per-class (G, s_slots) outputs, in final CSR slot order."""
    if dev_arrays is None:
        dev_arrays = plan.to_device(resolve_device(device), dtype)
    return [esc_digit_reduce(d["av"], d["bv"], d["slot"],
                             s_slots=plan.s_slots, budget_bytes=budget_bytes)
            for d in dev_arrays]


def esc_trim(plan: EscPlan, outs) -> CSR:
    """C from the padded group outputs: each group's [0, len) slots go to
    its contiguous interval of C's value array; sibling groups over the
    same interval (flop splits) accumulate, in f64."""
    c_val = np.zeros(plan.nnz_c, np.float64)
    for cls, out in zip(plan.classes, outs):
        arr = _host_f64(out)
        base, glen = cls["base"], cls["glen"]
        for gi in range(base.size):
            lo, ln = int(base[gi]), int(glen[gi])
            c_val[lo : lo + ln] += arr[gi, :ln]
    return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
               c_val, plan.shape)


def time_esc(plan: EscPlan, *, dtype=torch.float32, warmup: int = 2,
             iters: int = 10, device=None) -> float:
    """Median device ms of the digit mode's numeric phase (every width
    class) on resident streams, by CUDA events. Raises without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("time_esc needs a CUDA device")
    ops = plan.to_device(dev, dtype)
    return cuda_event_ms(lambda: esc_numeric(plan, ops), warmup=warmup,
                         iters=iters)


def time_esc_scan(plan: ScanPlan, *, warmup: int = 3, iters: int = 20,
                  device=None) -> float:
    """Median device ms of one scan-kernel launch on resident planes, by
    CUDA events. Raises without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("time_esc_scan needs a CUDA device")
    ops = plan.to_device(dev)
    return cuda_event_ms(lambda: esc_scan_numeric(plan, ops),
                         warmup=warmup, iters=iters)


def time_esc_any(plan, **kw) -> float:
    """Device ms of the numeric phase, dispatched on the plan's type."""
    if isinstance(plan, ScanPlan):
        return time_esc_scan(plan, **kw)
    return time_esc(plan, **kw)


# --- entry point ---------------------------------------------------------------

def is_f64(dtype) -> bool:
    """True for float64, False for float32 (torch or NumPy dtypes)."""
    name = str(dtype).removeprefix("torch.") if isinstance(
        dtype, torch.dtype) else np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64: {dtype}")
    return name == "float64"


def spgemm_esc(a: CSR, b: CSR, *, dtype=torch.float32,
               plan: ScanPlan | EscPlan | None = None, mode: str = "auto",
               device=None, moved: dict | None = None):
    """Unstructured C = A @ B through the ESC engine on `device` (None
    means CUDA). Returns (CSR, timings dict, plan); the plan is reusable
    for new values of the same pattern. mode "scan" (what "auto" runs
    without a plan): f32 runs the scan kernel, f64 the double-double
    kernel. mode "digit": the one-hot digit contraction (torch ops, f32
    or f64). A plan decides the mode ("auto" follows it; a mismatched
    mode raises).

    The timings are `span`s (utils/timing.py): route_ms
    (choose_group_rows, when the plan is built here), symbolic_ms,
    upload_ms, numeric_ms, compact_ms and, on the f32 scan route, its
    child download_ms (inside compact_ms). `moved`, a dict, gets the f32
    scan route's h2d_bytes and d2h_bytes."""
    f64 = is_f64(dtype)
    if mode not in ("auto", "scan", "digit"):
        raise ValueError(f"mode must be 'auto', 'scan' or 'digit': {mode!r}")
    if plan is not None:
        if not isinstance(plan, (ScanPlan, EscPlan)):
            raise TypeError(f"plan must be a ScanPlan or an EscPlan, got "
                            f"{type(plan).__name__}")
        plan_mode = "scan" if isinstance(plan, ScanPlan) else "digit"
        if mode not in ("auto", plan_mode):
            raise ValueError(
                f"plan is a {type(plan).__name__} but mode={mode!r}")
        mode = plan_mode
    elif mode == "auto":
        mode = "scan"
    dev = resolve_device(device)
    if mode == "digit":
        return _spgemm_esc_digit(a, b, plan, f64=f64, device=dev)
    timings: dict[str, float] = {}
    if plan is None:
        with span("route", timings):
            group_rows = choose_group_rows(a, b)
        plan = build_esc_scan_plan(a, b, keep_sources=f64,
                                   group_rows=group_rows)
    timings["symbolic_ms"] = plan.symbolic_ms
    if f64:
        with span("numeric", timings):
            c = esc_scan_dd(plan, a.data, b.data, device=dev)
        timings["upload_ms"] = 0.0
        timings["compact_ms"] = 0.0
        return c, timings, plan
    layout_cached = str(dev) in plan.__dict__.get("_combine_dev", {})
    with span("upload", timings):
        ops = plan.to_device(dev)
        _sync(dev)
    count_bytes(moved, "h2d_bytes", *ops.values())
    with span("numeric", timings):
        res, tail = esc_scan_numeric_combined(plan, ops)
        _sync(dev)
    if not layout_cached:  # the combine's index tensors went up with it
        classes, perm, sent = _combine_layout(plan, dev)
        count_bytes(moved, "h2d_bytes", perm, sent,
                    *(ii for _, ii in classes))
    del ops
    with span("compact", timings):
        c = esc_scan_trim_combined(plan, res, tail, timings, moved)
    return c, timings, plan


def _spgemm_esc_digit(a: CSR, b: CSR, plan: EscPlan | None, *, f64: bool,
                      device: torch.device):
    """The digit branch of spgemm_esc: plan, upload, contraction, trim."""
    timings: dict[str, float] = {}
    if plan is None:
        plan = build_esc_plan(a, b)
    timings["symbolic_ms"] = plan.symbolic_ms
    dtype = torch.float64 if f64 else torch.float32
    with span("upload", timings):
        ops = plan.to_device(device, dtype)
        _sync(device)
    with span("numeric", timings):
        outs = esc_numeric(plan, ops)
        _sync(device)
    del ops
    with span("compact", timings):
        c = esc_trim(plan, outs)
    return c, timings, plan
