"""Native (C++) host-format fast path, loaded via ctypes (port of
`spgemm_tpu/utils/native.py:21-278,639-947`).

Builds the shared source `native/csr2tile.cpp` with g++ into this
package's own build directory (`spgemm_tpu_torch/_build/`, gitignored),
under a name keyed on a hash of the source and flags. The build writes a
temporary file and renames it into place, so concurrent test workers never
load a half-written library. The NumPy code in models/tile.py and
ops/gustavson.py stays the fallback when the build fails.

Occupancy planes come back as uint16 arrays holding bfloat16 bit patterns
(0x3F80 = 1.0); ops/gustavson.py moves them to torch as bfloat16 views.
The JAX package's host-memory arena and buffer pool are a TPU-VM measure
and are not carried: buffers here are plain np.zeros / np.empty.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import sys
import tempfile
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG_DIR), "native", "csr2tile.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib = None
_tried = False

I8 = ctypes.POINTER(ctypes.c_int8)
I32 = ctypes.POINTER(ctypes.c_int32)
I64 = ctypes.POINTER(ctypes.c_int64)
U16 = ctypes.POINTER(ctypes.c_uint16)
U32 = ctypes.POINTER(ctypes.c_uint32)
F32 = ctypes.POINTER(ctypes.c_float)
F64 = ctypes.POINTER(ctypes.c_double)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_closure(src: str) -> list[str]:
    """`src` and every file it pulls in with `#include "..."`, recursively
    (each resolved beside the file that names it, as the compiler does
    first; a name that resolves to no file there is left to the compiler's
    search path and not followed), in first-seen order."""
    seen, todo = [], [os.path.abspath(src)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        for name in _INCLUDE.findall(text):
            dep = os.path.join(os.path.dirname(path), name.decode())
            if os.path.exists(dep):
                todo.append(os.path.abspath(dep))
    return seen


def library_path(src: str, stem: str, flags: list[str]) -> str:
    """BUILD_DIR/<stem>-<hash>.so for `src` built with `flags`: the hash
    covers the bytes of the source and of every file it includes with
    `#include "..."` (source_closure), and the flags, so an edited header
    never loads a library built from the old one."""
    digest = hashlib.sha256()
    for path in source_closure(src):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def build_shared_library(cmd_prefix: list[str], src: str, stem: str,
                         flags: list[str], timeout: float) -> str:
    """Compile `src` into library_path(src, stem, flags) unless that file
    already exists. The compiler's output is kept beside it as
    <name>.so.log. Raises subprocess.CalledProcessError (with the
    compiler's output) or FileNotFoundError. Shared by the g++ host build
    and the nvcc kernel build (ops/kernels.py)."""
    out = library_path(src, stem, flags)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run(cmd_prefix + flags + [src, "-o", tmp],
                             check=True, capture_output=True, text=True,
                             timeout=timeout)
        with open(tmp + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp + ".log", out + ".log")
        os.replace(tmp, out)
    finally:
        for p in (tmp, tmp + ".log"):
            if os.path.exists(p):
                os.unlink(p)
    return out


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = build_shared_library(["g++"], _SRC, "libspgemmtile",
                                        _FLAGS, timeout=300)
            lib = ctypes.CDLL(path)
        except (subprocess.SubprocessError, OSError) as e:
            detail = getattr(e, "stderr", "") or ""
            print(f"spgemm_tpu_torch: native build failed ({e}) {detail[-400:]}"
                  "; using NumPy converters", file=sys.stderr)
            return None
        lib.csr2tile_count.restype = ctypes.c_int64
        lib.gustavson_symbolic_count.restype = ctypes.c_int64
        lib.esc_scan_build.restype = ctypes.c_int64
        lib.esc_pattern_count.restype = ctypes.c_int64
        lib.esc_products_count.restype = ctypes.c_int64
        lib.esc_fill.restype = None
        for fn in (lib.esc_refresh_qv, lib.esc_refresh_dd,
                   lib.esc_gather_planes, lib.ozaki_absmax, lib.ozaki_span,
                   lib.ozaki_slice_a, lib.ozaki_slice_b):
            fn.restype = None
        _lib = lib
        return _lib


def csr_to_tiles_native(csr, tm: int, tn: int):
    """Native csr2tile; returns a TileMat or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from spgemm_tpu_torch.models.tile import MASK_DTYPE, TileMat, cdiv

    m, n = csr.shape
    gm = cdiv(m, tm)
    mw = cdiv(tn, 32)
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int32)
    indices = np.ascontiguousarray(csr.indices, dtype=np.int32)
    data = np.ascontiguousarray(csr.data, dtype=np.float64)
    # the C code trusts these invariants: a malformed CSR would read out
    # of bounds, so validate at the ctypes boundary
    if indptr.size != m + 1 or int(indptr[-1]) != indices.size \
            or indices.size != data.size:
        raise ValueError(
            f"malformed CSR: indptr has {indptr.size} entries for m={m}, "
            f"indptr[-1]={int(indptr[-1])}, nnz={indices.size}"
        )

    tptr = np.zeros(gm + 1, dtype=np.int32)
    nt = int(lib.csr2tile_count(
        _ptr(indptr, I32), _ptr(indices, I32),
        ctypes.c_int64(m), ctypes.c_int64(n),
        ctypes.c_int64(tm), ctypes.c_int64(tn),
        _ptr(tptr, I32),
    ))
    # only mask needs zeroing (the fill ORs bits into it); csr2tile_fill
    # writes every element of the other arrays
    trow = np.empty(nt, dtype=np.int32)
    tcol = np.empty(nt, dtype=np.int32)
    tnnz_ptr = np.empty(nt + 1, dtype=np.int32)
    rowptr = np.empty((nt, tm + 1), dtype=np.int32)
    mask = np.zeros((nt, tm, mw), dtype=MASK_DTYPE)
    rc = np.empty(csr.nnz, dtype=np.int32)
    val = np.empty(csr.nnz, dtype=np.float64)
    lib.csr2tile_fill(
        _ptr(indptr, I32), _ptr(indices, I32), _ptr(data, F64),
        ctypes.c_int64(m), ctypes.c_int64(n),
        ctypes.c_int64(tm), ctypes.c_int64(tn),
        _ptr(tptr, I32),
        _ptr(trow, I32), _ptr(tcol, I32), _ptr(tnnz_ptr, I32),
        _ptr(rowptr, I32), _ptr(mask, U32), _ptr(rc, I32), _ptr(val, F64),
    )
    return TileMat(shape=(m, n), tm=tm, tn=tn, trow=trow, tcol=tcol,
                   tptr=tptr, tnnz_ptr=tnnz_ptr, rc=rc, val=val, mask=mask,
                   rowptr=rowptr)


def tiles_to_csr_native(t):
    """Native tile2csr; returns a CSR or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from spgemm_tpu_torch.models.csr import CSR

    indptr = np.zeros(t.m + 1, dtype=np.int32)
    indices = np.zeros(t.nnz, dtype=np.int32)
    data = np.zeros(t.nnz, dtype=np.float64)
    lib.tile2csr(
        _ptr(np.ascontiguousarray(t.trow, np.int32), I32),
        _ptr(np.ascontiguousarray(t.tcol, np.int32), I32),
        _ptr(np.ascontiguousarray(t.tnnz_ptr, np.int32), I32),
        _ptr(np.ascontiguousarray(t.rowptr, np.int32), I32),
        _ptr(np.ascontiguousarray(t.rc, np.int32), I32),
        _ptr(np.ascontiguousarray(t.val, np.float64), F64),
        ctypes.c_int64(t.nt), ctypes.c_int64(t.m),
        ctypes.c_int64(t.tm), ctypes.c_int64(t.tn),
        _ptr(indptr, I32), _ptr(indices, I32), _ptr(data, F64),
    )
    return CSR(indptr, indices, data, t.shape)


def gustavson_symbolic_native(a, b, block_rows: int, max_b: int,
                              nt_a_pad: int, max_cblock_min: int = 1):
    """Native symbolic phase of the strip plan. Returns
    (c_tptr, ctrow, ctcol, slots, gather_idx, max_cblock, nt_c) or None
    if the library is unavailable. `max_cblock_min` forces a larger
    block-padded C geometry (the multi-device plans unify it).

    slots is sized nt_a_pad*max_b and prefilled with max_cblock (the
    garbage slot); only real (tile, y < cnt_b) pairs are written."""
    lib = get_lib()
    if lib is None:
        return None
    gm, gn_c = a.gm, b.gn
    tptr_a = np.ascontiguousarray(a.tptr, dtype=np.int32)
    tcol_a = np.ascontiguousarray(a.tcol, dtype=np.int32)
    tptr_b = np.ascontiguousarray(b.tptr, dtype=np.int32)
    tcol_b = np.ascontiguousarray(b.tcol, dtype=np.int32)

    c_tptr = np.zeros(gm + 1, dtype=np.int32)
    nt_c = int(lib.gustavson_symbolic_count(
        _ptr(tptr_a, I32), _ptr(tcol_a, I32),
        ctypes.c_int64(gm), ctypes.c_int64(gn_c),
        _ptr(tptr_b, I32), _ptr(tcol_b, I32),
        _ptr(c_tptr, I32),
    ))

    starts = np.minimum(
        np.append(np.arange(0, gm, block_rows), gm), gm).astype(np.int64)
    per_c = np.diff(c_tptr.astype(np.int64)[starts])
    max_cblock = max(max_cblock_min, int(per_c.max()) if per_c.size else 1)

    ctrow = np.zeros(nt_c, dtype=np.int32)
    ctcol = np.zeros(nt_c, dtype=np.int32)
    slots = np.full(nt_a_pad * max_b, max_cblock, dtype=np.int32)
    gather_idx = np.zeros(nt_c, dtype=np.int64)
    lib.gustavson_symbolic_fill(
        _ptr(tptr_a, I32), _ptr(tcol_a, I32),
        ctypes.c_int64(gm), ctypes.c_int64(gn_c),
        _ptr(tptr_b, I32), _ptr(tcol_b, I32),
        _ptr(c_tptr, I32),
        ctypes.c_int64(block_rows), ctypes.c_int64(max_cblock),
        ctypes.c_int64(max_b),
        _ptr(ctrow, I32), _ptr(ctcol, I32), _ptr(slots, I32),
        _ptr(gather_idx, I64),
    )
    return c_tptr, ctrow, ctcol, slots, gather_idx, max_cblock, nt_c


def pack_a_tiles_native(a, max_ablock: int):
    """Native packing of A's dense tile blocks: (a_val f32, a_occ uint16
    bfloat16 bits), each (nt + max_ablock, tm, tk). None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tm, tk = a.tm, a.tn
    tnnz_a = np.ascontiguousarray(a.tnnz_ptr, dtype=np.int32)
    rc_a = np.ascontiguousarray(a.rc, dtype=np.int32)
    val_a = np.ascontiguousarray(a.val, dtype=np.float64)
    a_val = np.zeros((a.nt + max_ablock, tm, tk), dtype=np.float32)
    a_occ = np.zeros((a.nt + max_ablock, tm, tk), dtype=np.uint16)
    lib.pack_tiles_dense(
        _ptr(tnnz_a, I32), _ptr(rc_a, I32), _ptr(val_a, F64),
        ctypes.c_int64(a.nt), ctypes.c_int64(tm * tk),
        _ptr(a_val, F32), _ptr(a_occ, U16),
    )
    return a_val, a_occ


def pack_strip_operands_native(a, b, max_ablock: int, max_b: int):
    """Native packing of the strip kernel's operands: A dense blocks and
    stacked B slabs (gk, tk, max_b*tn), values f32 and occupancy uint16
    bfloat16 bits. Returns (a_val, a_occ, b_val, b_occ) or None."""
    lib = get_lib()
    if lib is None:
        return None
    tk, tn = a.tn, b.tn
    a_val, a_occ = pack_a_tiles_native(a, max_ablock)
    tptr_b = np.ascontiguousarray(b.tptr, dtype=np.int32)
    tnnz_b = np.ascontiguousarray(b.tnnz_ptr, dtype=np.int32)
    rc_b = np.ascontiguousarray(b.rc, dtype=np.int32)
    val_b = np.ascontiguousarray(b.val, dtype=np.float64)
    gk = b.gm
    b_val = np.zeros((gk, tk, max_b * tn), dtype=np.float32)
    b_occ = np.zeros((gk, tk, max_b * tn), dtype=np.uint16)
    lib.pack_b_slabs(
        _ptr(tptr_b, I32), _ptr(tnnz_b, I32), _ptr(rc_b, I32),
        _ptr(val_b, F64),
        ctypes.c_int64(gk), ctypes.c_int64(tk), ctypes.c_int64(tn),
        ctypes.c_int64(max_b),
        _ptr(b_val, F32), _ptr(b_occ, U16),
    )
    return a_val, a_occ, b_val, b_occ


def esc_scan_symbolic_native(a, b, keep_sources: bool = True,
                             group_rows: int = 1):
    """Native symbolic of the ESC scan plan (ops/esc.py:ScanPlan): C's
    pattern, the destination-sorted (R, 128) product rows, the int32 meta
    plane and the window row pointer, in one call to esc_scan_build.
    keep_sources=False skips the a_src/b_src maps. Returns the
    _esc_scan_symbolic_numpy tuple, or None without the library.

    The planes are np.empty at a loose row bound r_ub: esc_scan_build
    writes every row below r_total exactly once, so only the block-padding
    tail [r_total, r_pad) is cleared afterwards. Zero-filling at r_ub
    would touch gigabytes at rmat scale; untouched pages cost nothing."""
    lib = get_lib()
    if lib is None:
        return None
    from spgemm_tpu_torch.ops.esc import SCAN_BLK, SCAN_WIN

    m, n = a.m, b.n
    ai = np.ascontiguousarray(a.indptr, np.int32)
    aj = np.ascontiguousarray(a.indices, np.int32)
    bi = np.ascontiguousarray(b.indptr, np.int32)
    bj = np.ascontiguousarray(b.indices, np.int32)

    # per-row product counts -> F and the nnzC upper bound
    blen = np.diff(bi.astype(np.int64))
    cs0 = np.zeros(aj.size + 1, np.int64)
    np.cumsum(blen[aj], out=cs0[1:])
    flops = int(cs0[-1])
    if flops == 0:
        # empty product stream: SCAN_BLK-row zero planes, one empty window
        zf = np.zeros((SCAN_BLK, SCAN_WIN), np.float32)
        zi = np.zeros((SCAN_BLK, SCAN_WIN), np.int32)
        asrc = bsrc = (zi if keep_sources else None)
        return (np.zeros(m + 1, np.int64), np.zeros(0, np.int32), 0,
                zf, zi, np.zeros(2, np.int64), asrc, bsrc, 1)

    row_f = cs0[ai[1:].astype(np.int64)] - cs0[ai[:-1].astype(np.int64)]
    ub_total = max(1, int(np.minimum(row_f, n).sum()))
    n_win_ub = ub_total // SCAN_WIN + 1
    # every window may pad up to group_rows-1 extra rows
    r_ub = (flops + SCAN_WIN - 1) // SCAN_WIN + n_win_ub * group_rows \
        + SCAN_BLK

    c_indptr = np.zeros(m + 1, np.int32)
    c_indices = np.empty(ub_total, np.int32)
    qv = np.empty((r_ub, SCAN_WIN), np.float32)
    meta = np.empty((r_ub, SCAN_WIN), np.int32)
    if keep_sources:
        asrc = np.empty((r_ub, SCAN_WIN), np.int32)
        bsrc = np.empty((r_ub, SCAN_WIN), np.int32)
    else:
        asrc = bsrc = np.zeros(1, np.int32)  # not written
    win_rowptr_buf = np.empty(n_win_ub + 1, np.int64)
    stats = np.zeros(8, np.int64)  # [0] max run, [1] r_total
    ad = np.ascontiguousarray(a.data, np.float64)
    bd = np.ascontiguousarray(b.data, np.float64)
    nnz_c = int(lib.esc_scan_build(
        _ptr(ai, I32), _ptr(aj, I32), _ptr(bi, I32), _ptr(bj, I32),
        _ptr(ad, F64), _ptr(bd, F64),
        ctypes.c_int64(m), ctypes.c_int64(n),
        _ptr(c_indptr, I32), _ptr(c_indices, I32),
        _ptr(qv, F32), _ptr(meta, I32),
        _ptr(asrc, I32), _ptr(bsrc, I32),
        ctypes.c_int64(1 if keep_sources else 0),
        ctypes.c_int64(group_rows),
        ctypes.c_int64(r_ub),
        _ptr(win_rowptr_buf, I64), _ptr(stats, I64)))

    n_win = max(1, -(-nnz_c // SCAN_WIN))
    win_rowptr = win_rowptr_buf[: n_win + 1]
    # pad R to the SCAN_BLK multiple and clear the tail the build never
    # wrote (no window reaches it, but the kernels stream it)
    r_total = int(stats[1])
    r_pad = -(-r_total // SCAN_BLK) * SCAN_BLK
    qv, meta = qv[:r_pad], meta[:r_pad]
    qv[r_total:] = 0.0
    meta[r_total:] = 0
    if keep_sources:
        asrc, bsrc = asrc[:r_pad], bsrc[:r_pad]
        asrc[r_total:] = -1
        bsrc[r_total:] = 0
    else:
        asrc = bsrc = None
    return (c_indptr.astype(np.int64), c_indices[:nnz_c], flops, qv, meta,
            win_rowptr, asrc, bsrc, max(1, int(stats[0])))


def esc_symbolic_native(a, b, s_slots: int, f_max: int, w_min: int):
    """Native symbolic of the ESC digit plan (ops/esc.py:EscPlan): C's
    pattern, per-interval product counts, and the padded per-class
    operand-stream fill (esc_pattern_count, esc_products_count, esc_fill).
    Returns (c_indptr i64, c_indices i32, flops, prod_cnt i64, asrc, bsrc,
    slot, layout, av, bv), `layout` being the ops/esc.py:_sibling_layout
    the fill was written against, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    from spgemm_tpu_torch.ops.esc import _sibling_layout

    m, n = a.m, b.n
    ai = np.ascontiguousarray(a.indptr, np.int32)
    aj = np.ascontiguousarray(a.indices, np.int32)
    bi = np.ascontiguousarray(b.indptr, np.int32)
    bj = np.ascontiguousarray(b.indices, np.int32)

    c_indptr = np.zeros(m + 1, np.int32)
    nnz_c = int(lib.esc_pattern_count(
        _ptr(ai, I32), _ptr(aj, I32), _ptr(bi, I32), _ptr(bj, I32),
        ctypes.c_int64(m), ctypes.c_int64(n), _ptr(c_indptr, I32)))

    n_int = max(1, -(-nnz_c // s_slots))
    c_indices = np.zeros(nnz_c, np.int32)
    prod_cnt = np.zeros(n_int, np.int64)
    flops = int(lib.esc_products_count(
        _ptr(ai, I32), _ptr(aj, I32), _ptr(bi, I32), _ptr(bj, I32),
        ctypes.c_int64(m), ctypes.c_int64(n), _ptr(c_indptr, I32),
        _ptr(c_indices, I32), ctypes.c_int64(s_slots),
        _ptr(prod_cnt, I64)))

    layout = _sibling_layout(prod_cnt, nnz_c, s_slots, f_max, w_min)
    flat = layout["flat_total"]
    asrc = np.full(flat, -1, np.int32)
    bsrc = np.zeros(flat, np.int32)
    slot = np.zeros(flat, np.int32)
    av = np.zeros(flat, np.float64)
    bv = np.zeros(flat, np.float64)
    if flops:
        ad = np.ascontiguousarray(a.data, np.float64)
        bd = np.ascontiguousarray(b.data, np.float64)
        lib.esc_fill(
            _ptr(ai, I32), _ptr(aj, I32), _ptr(bi, I32), _ptr(bj, I32),
            _ptr(ad, F64), _ptr(bd, F64),
            ctypes.c_int64(m), ctypes.c_int64(n), _ptr(c_indptr, I32),
            _ptr(c_indices, I32), ctypes.c_int64(s_slots),
            ctypes.c_int64(f_max),
            _ptr(layout["sib_ptr"], I64), _ptr(layout["sib_base"], I64),
            ctypes.c_int64(n_int),
            _ptr(asrc, I32), _ptr(bsrc, I32), _ptr(slot, I32),
            _ptr(av, F64), _ptr(bv, F64))
    return (c_indptr.astype(np.int64), c_indices, flops, prod_cnt,
            asrc, bsrc, slot, layout, av, bv)


def _value_sources(asrc, bsrc, a_data, b_data):
    return (np.ascontiguousarray(asrc, np.int32),
            np.ascontiguousarray(bsrc, np.int32),
            np.ascontiguousarray(a_data, np.float64),
            np.ascontiguousarray(b_data, np.float64))


def esc_refresh_qv_native(asrc, bsrc, a_data, b_data, out=None):
    """Fused gather-multiply-round refresh of a ScanPlan's qv plane (f64
    product rounded once to f32; padding lanes 0). Writes into `out` when
    given. Returns the f32 plane, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    asrc, bsrc, ad, bd = _value_sources(asrc, bsrc, a_data, b_data)
    if out is None:
        out = np.empty(asrc.shape, np.float32)
    lib.esc_refresh_qv(
        _ptr(asrc, I32), _ptr(bsrc, I32), _ptr(ad, F64), _ptr(bd, F64),
        ctypes.c_int64(asrc.size), _ptr(out, F32))
    return out


def esc_refresh_dd_native(asrc, bsrc, a_data, b_data):
    """Double-double planes: the exact f64 product split into (hi, lo) f32.
    Returns (hi, lo), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    asrc, bsrc, ad, bd = _value_sources(asrc, bsrc, a_data, b_data)
    hi = np.empty(asrc.shape, np.float32)
    lo = np.empty(asrc.shape, np.float32)
    lib.esc_refresh_dd(
        _ptr(asrc, I32), _ptr(bsrc, I32), _ptr(ad, F64), _ptr(bd, F64),
        ctypes.c_int64(asrc.size), _ptr(hi, F32), _ptr(lo, F32))
    return hi, lo


def esc_gather_planes_native(asrc, bsrc, a_data, b_data):
    """Separate (av, bv) f32 operand planes for the in-kernel-multiply
    scan variant (padding lanes 0). Returns (av, bv), or None."""
    lib = get_lib()
    if lib is None:
        return None
    asrc, bsrc, ad, bd = _value_sources(asrc, bsrc, a_data, b_data)
    av = np.empty(asrc.shape, np.float32)
    bv = np.empty(asrc.shape, np.float32)
    lib.esc_gather_planes(
        _ptr(asrc, I32), _ptr(bsrc, I32), _ptr(ad, F64), _ptr(bd, F64),
        ctypes.c_int64(asrc.size), _ptr(av, F32), _ptr(bv, F32))
    return av, bv


def _tile_csr(t):
    return (np.ascontiguousarray(t.tnnz_ptr, np.int32),
            np.ascontiguousarray(t.rc, np.int32),
            np.ascontiguousarray(t.val, np.float64))


def ozaki_scales_native(t, axis: int):
    """Per-row (axis=0) or per-column (axis=1) |v| maxima of a TileMat,
    shape (gdim*span,) f64: the scale pass of ops/ozaki.py's
    _scales_and_slices_prep, from tile CSR (no dense cube). None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    span = t.tm if axis == 0 else t.tn
    gdim = t.gm if axis == 0 else t.gn
    owner = np.ascontiguousarray(t.trow if axis == 0 else t.tcol, np.int32)
    tnnz, rc, val = _tile_csr(t)
    out = np.zeros(gdim * span, np.float64)
    lib.ozaki_absmax(
        _ptr(tnnz, I32), _ptr(rc, I32), _ptr(val, F64), _ptr(owner, I32),
        ctypes.c_int64(t.nt), ctypes.c_int64(t.tn),
        ctypes.c_int64(span), ctypes.c_int64(axis), _ptr(out, F64))
    return out


def ozaki_span_native(t, axis: int, exps: np.ndarray):
    """(bit span, |v| max, nonzero |v| min) of a TileMat against its
    scale exponents: ops/ozaki.py:_span_slices plus the extreme-span
    routing stats, from tile CSR. None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    span = t.tm if axis == 0 else t.tn
    gdim = t.gm if axis == 0 else t.gn
    owner = np.ascontiguousarray(t.trow if axis == 0 else t.tcol, np.int32)
    tnnz, rc, val = _tile_csr(t)
    e = np.ascontiguousarray(exps, np.int64)
    if e.size != gdim * span:
        raise ValueError(f"exps: need {gdim * span} exponents, got {e.size}")
    out3 = np.zeros(3, np.float64)
    lib.ozaki_span(
        _ptr(tnnz, I32), _ptr(rc, I32), _ptr(val, F64), _ptr(owner, I32),
        ctypes.c_int64(t.nt), ctypes.c_int64(t.tn),
        ctypes.c_int64(span), ctypes.c_int64(axis), _ptr(e, I64),
        _ptr(out3, F64))
    return int(out3[0]), float(out3[1]), float(out3[2])


def _check_int8_out(name: str, arr: np.ndarray, shape_tail: tuple,
                    min_rows: int) -> None:
    # the C passes trust the layout: validate it at the ctypes boundary
    if (arr.dtype != np.int8 or not arr.flags.c_contiguous
            or arr.ndim != 3 or arr.shape[1:] != shape_tail
            or arr.shape[0] < min_rows):
        raise ValueError(f"{name}: need a C-contiguous int8 array of shape "
                         f"(>={min_rows}, {shape_tail[0]}, {shape_tail[1]}), "
                         f"got {arr.dtype} {arr.shape}")


def ozaki_slice_a_native(t, sa: int, stack_rows: int, ea: np.ndarray,
                         av8: np.ndarray) -> bool:
    """Write A's int8 digit stacks av8[t, s*tm + r, c] straight from
    tile CSR into av8 (zeroed, (nt_pad, stack_rows, tk)). False if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    if stack_rows < sa * t.tm:
        raise ValueError(f"stack_rows {stack_rows} < sa*tm = {sa * t.tm}")
    _check_int8_out("av8", av8, (stack_rows, t.tn), t.nt)
    tnnz, rc, val = _tile_csr(t)
    trow = np.ascontiguousarray(t.trow, np.int32)
    e = np.ascontiguousarray(ea, np.int64)
    lib.ozaki_slice_a(
        _ptr(tnnz, I32), _ptr(rc, I32), _ptr(val, F64), _ptr(trow, I32),
        ctypes.c_int64(t.nt), ctypes.c_int64(t.tm), ctypes.c_int64(t.tn),
        ctypes.c_int64(sa), ctypes.c_int64(stack_rows), _ptr(e, I64),
        _ptr(av8, I8))
    return True


def ozaki_slice_b_native(t, max_b: int, sb: int, eb: np.ndarray,
                         bv8: np.ndarray) -> bool:
    """Write B's int8 digit stacks bv8[k, r, (s*max_b + y)*tn + c]
    straight from tile CSR into bv8 (zeroed, (gk_pad, tk, sb*max_b*tn)).
    False if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    _check_int8_out("bv8", bv8, (t.tm, sb * max_b * t.tn), t.gm)
    tptr = np.ascontiguousarray(t.tptr, np.int32)
    tnnz, rc, val = _tile_csr(t)
    tcol = np.ascontiguousarray(t.tcol, np.int32)
    e = np.ascontiguousarray(eb, np.int64)
    lib.ozaki_slice_b(
        _ptr(tptr, I32), _ptr(tnnz, I32), _ptr(rc, I32), _ptr(val, F64),
        _ptr(tcol, I32), ctypes.c_int64(t.gm), ctypes.c_int64(t.tm),
        ctypes.c_int64(t.tn), ctypes.c_int64(max_b), ctypes.c_int64(sb),
        _ptr(e, I64), _ptr(bv8, I8))
    return True
