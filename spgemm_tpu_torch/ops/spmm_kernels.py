"""The hand-written CUDA kernel of the strip SpMM route and its plain
PyTorch version.

`spmm_strip` is the port of `spgemm_tpu/ops/pallas_kernels.py:
spmm_strip_pallas` (:757, X resident, reaching `_spmm_kernel_factory`
:679) and of `spmm_window_pallas` (:894, an X window per block, reaching
`_spmm_window_kernel_factory` :805). Both compute the same Y = A·X from the
same (aptr, ak, arow) plan, so one CUDA source, `csrc/spmm_strip.cu`,
serves both: `kmin` None is the resident form, `kmin` set the window form.
The packed width of X and Y picks the kernel: 8, 16 or 32 columns (k up
to 32, `pack_width`) the narrow form, a multiple of 128 the 128-column
form. The source's header says what bounds each on an H100 and what its
design does about it.

For CPU tensors the wrapper runs the plain PyTorch version; for CUDA
tensors it launches the kernel or raises. It never falls back. The library
is built with nvcc at first use (never at import) into
`spgemm_tpu_torch/_build/`; its build key covers the source and the
headers it includes.

Launch counters: `spmm_strip.kernel_launches` counts kernel launches (both
forms), `spmm_strip.narrow_launches` those of the narrow form, and
`spmm_strip.plain_launches` dispatches to the plain version. Only the
wrapper increments them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from spgemm_tpu_torch.ops.kernels import build_cuda_library

# A tile heights the CUDA kernel is instantiated for; tk is free
SPMM_TM = (8, 16, 32, 64)
KCOLS = 128          # k_pad is a multiple of this (one CTA per 128 columns)
NARROW_WIDTHS = (8, 16, 32)  # packed widths of the narrow form (k <= 32)
# bytes of temporaries the plain version allows per chunk of A tiles
_PLAIN_CHUNK_BYTES = 256 << 20

KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "spmm_strip.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def load_spmm_kernel():
    """Build (once per source hash) and load the SpMM kernel library.
    Fills `build_info` with the library path, build seconds and the
    compiler's -Xptxas -v report."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib, info = build_cuda_library(KERNEL_SRC, "libspmm_strip",
                                       NVCC_FLAGS)
        lib.spmm_strip_f32.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
        lib.spmm_strip_f32.restype = ctypes.c_int
        build_info.update(info)
        _lib = lib
        return _lib


def pack_width(k: int) -> int:
    """The width X and Y are packed at for k columns: k rounded up to a
    power of two of at least 8 while k <= 32 (the narrow form), else k
    rounded up to a multiple of 128 (the JAX package's k_pad)."""
    if k <= NARROW_WIDTHS[-1]:
        return next(w for w in NARROW_WIDTHS if w >= k)
    return -(-k // KCOLS) * KCOLS


def _check_operands(a_dense, xb, aptr, ak, arow, kmin, *, gm, block_rows):
    dev = a_dense.device
    if a_dense.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"a_dense: need float32 or float64, got "
                         f"{a_dense.dtype}")
    named = [("a_dense", a_dense, a_dense.dtype), ("xb", xb, a_dense.dtype),
             ("aptr", aptr, torch.int32), ("ak", ak, torch.int32),
             ("arow", arow, torch.int32)]
    if kmin is not None:
        named.append(("kmin", kmin, torch.int32))
    for name, t, dt in named:
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if a_dense.dim() != 3 or xb.dim() != 3:
        raise ValueError("a_dense is (ntA_pad, tm, tk), xb (gk, tk, k_pad)")
    n_blocks = max(1, -(-gm // block_rows))
    if (xb.shape[1] != a_dense.shape[2] or aptr.numel() != gm + 1
            or ak.numel() != a_dense.shape[0]
            or arow.numel() != a_dense.shape[0]
            or (kmin is not None and kmin.numel() != n_blocks)
            or min(gm, block_rows) < 1):
        raise ValueError(
            f"inconsistent SpMM operands: a_dense {tuple(a_dense.shape)}, "
            f"xb {tuple(xb.shape)}, aptr {aptr.numel()}, ak {ak.numel()}, "
            f"arow {arow.numel()}, kmin "
            f"{None if kmin is None else kmin.numel()}, gm={gm} "
            f"block_rows={block_rows}")
    return n_blocks


def spmm_strip_plain(a_dense, xb, aptr, ak, arow, kmin=None, *, gm: int,
                     block_rows: int):
    """Plain PyTorch version of the strip SpMM kernel, on any device: for
    the plan's real A tiles g < aptr[gm], in chunks, A_g @ X slab ak[g] by
    `bmm`, index_add_ed into tile-row arow[g]. The window form reads the
    same slab (kmin[blk] + (ak[g] - kmin[blk]) is ak[g]), so kmin changes
    no value. Returns Y (n_blocks*block_rows, tm, k_pad) in a_dense's
    dtype; rows past gm are zero."""
    ntp, tm, tk = a_dense.shape
    k_pad = xb.shape[2]
    n_blocks = max(1, -(-gm // block_rows))
    y = torch.zeros(n_blocks * block_rows, tm, k_pad, dtype=a_dense.dtype,
                    device=a_dense.device)
    nt = int(aptr[gm])
    per_tile = (tm * tk + tk * k_pad + tm * k_pad) * a_dense.element_size()
    chunk = max(1, _PLAIN_CHUNK_BYTES // per_tile)
    for lo in range(0, nt, chunk):
        g = torch.arange(lo, min(nt, lo + chunk), device=a_dense.device)
        y.index_add_(0, arow[g].long(),
                     torch.bmm(a_dense[g], xb[ak[g].long()]))
    return y


def spmm_strip(a_dense, xb, aptr, ak, arow, kmin=None, *, gm: int,
               block_rows: int):
    """Strip SpMM Y = A·X on the packed operands (see
    ops/spmm.py:SpmmOperands.to_device): a_dense (ntA_pad, tm, tk), xb
    (gk, tk, k_pad), aptr (gm+1,), ak and arow (ntA_pad,), and for the
    window form kmin (n_blocks,). Returns Y (n_blocks*block_rows, tm,
    k_pad); rows past gm are zero. k_pad is xb's packed width: 8, 16 or 32
    launches the narrow form, a multiple of 128 the 128-column form. CPU
    tensors run spmm_strip_plain (f32 or f64, any width); CUDA tensors
    launch csrc/spmm_strip.cu (f32 only)."""
    kw = dict(gm=gm, block_rows=block_rows)
    n_blocks = _check_operands(a_dense, xb, aptr, ak, arow, kmin, **kw)
    if a_dense.device.type == "cpu":
        spmm_strip.plain_launches += 1
        return spmm_strip_plain(a_dense, xb, aptr, ak, arow, kmin, **kw)
    if a_dense.device.type != "cuda":
        raise ValueError(f"spmm_strip runs on cpu or cuda, not "
                         f"{a_dense.device}")
    _, tm, tk = a_dense.shape
    k_pad = xb.shape[2]
    n_rows = n_blocks * block_rows
    if a_dense.dtype != torch.float32:
        raise ValueError(f"the SpMM kernel takes float32, got "
                         f"{a_dense.dtype}")
    narrow = k_pad in NARROW_WIDTHS
    if tm not in SPMM_TM or not narrow and (
            k_pad % KCOLS or k_pad // KCOLS > 65535):
        raise ValueError(f"the SpMM kernel takes tm in {SPMM_TM} and k_pad "
                         f"in {NARROW_WIDTHS} or a multiple of {KCOLS}, got "
                         f"tm={tm} k_pad={k_pad}")
    if n_rows >= 2 ** 31:
        raise ValueError("SpMM kernel grid exceeds 2^31-1 rows")
    if a_dense.data_ptr() % 16 or xb.data_ptr() % 16:
        raise ValueError("the SpMM kernel copies 16-byte runs: a_dense and "
                         "xb must start 16-byte aligned")
    lib = load_spmm_kernel()
    y = torch.empty(n_rows, tm, k_pad, dtype=torch.float32,
                    device=a_dense.device)
    with torch.cuda.device(a_dense.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.spmm_strip_f32(
            a_dense.data_ptr(), xb.data_ptr(), aptr.data_ptr(),
            ak.data_ptr(), None if kmin is None else kmin.data_ptr(),
            y.data_ptr(), gm, block_rows, n_rows, tm, tk, k_pad, stream)
    if err != 0:
        raise RuntimeError(f"SpMM kernel launch failed: CUDA error {err}")
    spmm_strip.kernel_launches += 1
    spmm_strip.narrow_launches += narrow
    return y


spmm_strip.kernel_launches = 0
spmm_strip.narrow_launches = 0
spmm_strip.plain_launches = 0
