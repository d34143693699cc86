"""Hand-written CUDA kernels of the ESC scan route and their plain PyTorch
versions.

`esc_scan`, `esc_scan_mul` and `esc_scan_dd` are the ports of the three
Pallas scan kernels of `spgemm_tpu/ops/esc.py`: `esc_scan_pallas` (:662),
`esc_scan_mul_pallas` (:713) and `esc_scan_dd_pallas` (:760). One CUDA
source, `csrc/esc_scan.cu`, serves all three; its header says what the
kernels compute, what bounds them on an H100 and what the design does
about it.

For CPU tensors a wrapper runs the plain PyTorch version; for CUDA
tensors it launches the kernel or raises. It never falls back. The
kernels add in the reference's order and are built with --fmad=false, so
on the card they are bit-equal to the plain versions. The library is
built with nvcc at first use (never at import) into
`spgemm_tpu_torch/_build/`, keyed on a hash of the source and flags.

Launch counters: each wrapper's `kernel_launches` counts kernel launches
and `plain_launches` dispatches to the plain version. Only the wrappers
increment them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from spgemm_tpu_torch.ops.kernels import build_cuda_library

LANES = 128                 # SCAN_WIN: lanes per plane row
_PLAIN_CHUNK_ROWS = 1 << 17  # rows per step of the plain versions (a
                             # multiple of every G; bounds temporaries)

KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "esc_scan.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def load_scan_kernel():
    """Build (once per source hash) and load the scan kernel library.
    Fills `build_info` with the library path, build seconds and the
    compiler's -Xptxas -v report."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib, info = build_cuda_library(KERNEL_SRC, "libesc_scan", NVCC_FLAGS)
        for name, n_ptr in (("esc_scan_f32", 3), ("esc_scan_mul_f32", 4),
                            ("esc_scan_dd_f32", 5)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 3
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        build_info.update(info)
        _lib = lib
        return _lib


def _check_operands(planes, meta, passes: int, group_rows: int) -> None:
    dev = meta.device
    if meta.dtype != torch.int16 or meta.dim() != 2 \
            or meta.shape[1] != LANES or not meta.is_contiguous():
        raise ValueError(f"meta: need a contiguous (R, {LANES}) int16 "
                         f"tensor, got {meta.dtype} {tuple(meta.shape)}")
    for i, t in enumerate(planes):
        if t.dtype != torch.float32 or t.device != dev \
                or t.shape != meta.shape or not t.is_contiguous():
            raise ValueError(
                f"plane {i}: need a contiguous float32 {tuple(meta.shape)} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")
    if group_rows not in (1, 2, 4, 8) or meta.shape[0] % group_rows:
        raise ValueError(f"group_rows must be 1, 2, 4 or 8 and divide "
                         f"R={meta.shape[0]}: {group_rows}")
    if not 0 <= passes <= 7:
        raise ValueError(f"passes must lie in [0, 7] (runs span at most "
                         f"{LANES} lanes): {passes}")


# --- plain PyTorch versions -------------------------------------------------
# The reference's arithmetic, in its order: each doubling step is
# q + where(dist >= d, roll(q, -d), 0); the gather multiplies by the 0/1
# present flag; the G rows are summed left to right.

def _meta_fields(mt: torch.Tensor):
    """(idx, present, dist) from an int16 meta block; the widening to
    int32 is a sign extension, as esc.py:394-396."""
    m = mt.to(torch.int32)
    return (m & 127).long(), ((m >> 7) & 1).to(torch.float32), m >> 8


def two_sum_acc(s, e, x, ex):
    """Compensated s + x: the 2Sum of esc.py:793-798. Returns (s, e)."""
    t = s + x
    bp = t - s
    err = (s - (t - bp)) + (x - bp)
    return t, e + ex + err


def _chunks(n_rows: int):
    for lo in range(0, n_rows, _PLAIN_CHUNK_ROWS):
        yield lo, min(n_rows, lo + _PLAIN_CHUNK_ROWS)


def _scan_f32(q, mt, passes: int, g: int):
    idx, present, dist = _meta_fields(mt)
    for k in range(passes):
        d = 1 << k
        q = q + torch.where(dist >= d, torch.roll(q, -d, 1), 0.0)
    y = torch.gather(q, 1, idx) * present
    if g == 1:
        return y
    y3 = y.view(-1, g, LANES)
    acc = y3[:, 0]
    for j in range(1, g):
        acc = acc + y3[:, j]
    return acc


def esc_scan_plain(qv, meta, *, passes: int, group_rows: int):
    """Plain PyTorch version of the scan kernel (esc_scan_pallas), on any
    device. Returns (R/G, 128) float32."""
    g = group_rows
    out = torch.empty(meta.shape[0] // g, LANES, dtype=torch.float32,
                      device=meta.device)
    for lo, hi in _chunks(meta.shape[0]):
        out[lo // g : hi // g] = _scan_f32(qv[lo:hi], meta[lo:hi], passes, g)
    return out


def esc_scan_mul_plain(av, bv, meta, *, passes: int, group_rows: int):
    """Plain PyTorch version of the in-kernel-multiply scan kernel
    (esc_scan_mul_pallas): q = av*bv, then the scan."""
    g = group_rows
    out = torch.empty(meta.shape[0] // g, LANES, dtype=torch.float32,
                      device=meta.device)
    for lo, hi in _chunks(meta.shape[0]):
        out[lo // g : hi // g] = _scan_f32(av[lo:hi] * bv[lo:hi],
                                           meta[lo:hi], passes, g)
    return out


def esc_scan_dd_plain(qh, ql, meta, *, passes: int, group_rows: int):
    """Plain PyTorch version of the double-double scan kernel
    (esc_scan_dd_pallas). Returns the (s, e) planes, (R/G, 128) each."""
    g = group_rows
    shape = (meta.shape[0] // g, LANES)
    out_s = torch.empty(shape, dtype=torch.float32, device=meta.device)
    out_e = torch.empty_like(out_s)
    for lo, hi in _chunks(meta.shape[0]):
        s, e = qh[lo:hi], ql[lo:hi]
        idx, present, dist = _meta_fields(meta[lo:hi])
        for k in range(passes):
            d = 1 << k
            ok = dist >= d
            sr = torch.where(ok, torch.roll(s, -d, 1), 0.0)
            er = torch.where(ok, torch.roll(e, -d, 1), 0.0)
            s, e = two_sum_acc(s, e, sr, er)
        ys = torch.gather(s, 1, idx) * present
        ye = torch.gather(e, 1, idx) * present
        if g > 1:
            ys3, ye3 = ys.view(-1, g, LANES), ye.view(-1, g, LANES)
            ys, ye = ys3[:, 0], ye3[:, 0]
            for j in range(1, g):
                ys, ye = two_sum_acc(ys, ye, ys3[:, j], ye3[:, j])
        out_s[lo // g : hi // g] = ys
        out_e[lo // g : hi // g] = ye
    return out_s, out_e


# --- wrappers ----------------------------------------------------------------

def _launch(fn_name: str, planes, meta, n_out: int, passes: int,
            group_rows: int):
    if meta.device.type != "cuda":
        raise ValueError(f"the scan kernels run on cpu or cuda, not "
                         f"{meta.device}")
    for t in (*planes, meta):
        if t.data_ptr() % 16:
            raise ValueError("the scan kernels read 16-byte rows: every "
                             "plane must start 16-byte aligned")
    lib = load_scan_kernel()
    outs = [torch.empty(meta.shape[0] // group_rows, LANES,
                        dtype=torch.float32, device=meta.device)
            for _ in range(n_out)]
    with torch.cuda.device(meta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(
            *[t.data_ptr() for t in planes], meta.data_ptr(),
            *[t.data_ptr() for t in outs], meta.shape[0], passes,
            group_rows, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    return outs


def esc_scan(qv, meta, *, passes: int, group_rows: int):
    """ESC scan numeric phase on the plan's planes: qv (R, 128) float32,
    meta (R, 128) int16. Returns (R/G, 128) float32. CPU tensors run
    esc_scan_plain; CUDA tensors launch csrc/esc_scan.cu."""
    _check_operands((qv,), meta, passes, group_rows)
    kw = dict(passes=passes, group_rows=group_rows)
    if meta.device.type == "cpu":
        esc_scan.plain_launches += 1
        return esc_scan_plain(qv, meta, **kw)
    (out,) = _launch("esc_scan_f32", (qv,), meta, 1, **kw)
    esc_scan.kernel_launches += 1
    return out


def esc_scan_mul(av, bv, meta, *, passes: int, group_rows: int):
    """The scan with q = av*bv formed in the kernel (EscExecutor
    mode="mul"). Returns (R/G, 128) float32."""
    _check_operands((av, bv), meta, passes, group_rows)
    kw = dict(passes=passes, group_rows=group_rows)
    if meta.device.type == "cpu":
        esc_scan_mul.plain_launches += 1
        return esc_scan_mul_plain(av, bv, meta, **kw)
    (out,) = _launch("esc_scan_mul_f32", (av, bv), meta, 1, **kw)
    esc_scan_mul.kernel_launches += 1
    return out


def esc_scan_dd(qh, ql, meta, *, passes: int, group_rows: int):
    """Double-double scan over the (hi, lo) float32 planes of the exact
    f64 products. Returns the (s, e) planes, (R/G, 128) float32 each."""
    _check_operands((qh, ql), meta, passes, group_rows)
    kw = dict(passes=passes, group_rows=group_rows)
    if meta.device.type == "cpu":
        esc_scan_dd.plain_launches += 1
        return esc_scan_dd_plain(qh, ql, meta, **kw)
    s, e = _launch("esc_scan_dd_f32", (qh, ql), meta, 2, **kw)
    esc_scan_dd.kernel_launches += 1
    return s, e


WRAPPERS = (esc_scan, esc_scan_mul, esc_scan_dd)
for _w in WRAPPERS:
    _w.kernel_launches = 0
    _w.plain_launches = 0
