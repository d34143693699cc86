"""Hand-written CUDA kernels and their plain PyTorch versions.

`strip_numeric` is the port of `spgemm_tpu/ops/pallas_kernels.py:
gustavson_strip_pallas` (:538), which reaches the two Pallas strip kernels
`_strip_window_kernel_factory` (:406, windowed B) and
`_strip_kernel_factory` (:219, cached B). One CUDA kernel,
`csrc/strip_numeric.cu`, replaces both: they compute the same function
from the same plan. It runs on the tensor cores: values as 3xTF32
(f32-accurate split operands), counts as bf16 products of the 0/1
occupancy planes. The source file's header says what bounds the kernel
on an H100 and what its design does about it.

For a CPU tensor the wrapper runs the plain PyTorch version; for a CUDA
tensor it launches the kernel or raises. It never falls back. The kernel
is built with nvcc at first use (never at import: the CPU tests import
this module) into `spgemm_tpu_torch/_build/`, keyed on a hash of the
source and flags, and loaded with ctypes.

Launch counters: `strip_numeric.kernel_launches` counts kernel launches
and `strip_numeric.plain_launches` counts dispatches to the plain
version. Only the wrapper increments them.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
import time

import torch

from spgemm_tpu_torch.utils.native import build_shared_library

# (tm, tn) tile shapes the CUDA kernel is instantiated for; tk is any
# multiple of TK_MULTIPLE (its staging copies 16-byte runs of bf16).
SUPPORTED_TILES = ((8, 128), (16, 128), (32, 128), (64, 128))
TK_MULTIPLE = 8
# pairs the plain version multiplies at once (bounds its temporaries)
_PLAIN_CHUNK = 4096

KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "strip_numeric.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from spgemm_tpu_torch/csrc at first use")


def build_cuda_library(src: str, stem: str, flags: list[str]):
    """Build `src` with nvcc (once per source hash and flags) and load it.
    Returns (ctypes.CDLL, info) where info holds the library path, the
    build seconds and the compiler's -Xptxas -v report. Shared by every
    kernel module of the port."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    try:
        path = build_shared_library([nvcc], src, stem, flags, timeout=900)
    except (subprocess.SubprocessError, OSError) as e:
        detail = getattr(e, "stderr", "") or ""
        raise RuntimeError(f"{stem} build failed: {e}\n{detail}") from e
    lib = ctypes.CDLL(path)
    log = path + ".log"
    info = dict(path=path, seconds=time.perf_counter() - t0,
                ptxas=open(log).read() if os.path.exists(log) else "")
    return lib, info


def ptxas_usage(log: str) -> dict:
    """{kernel symbol: (registers, spill store bytes, spill load bytes)}
    from an `nvcc -Xptxas -v` report."""
    usage, fn, spills = {}, None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            usage[fn] = (int(m.group(1)),) + spills
    return usage


def load_strip_kernel():
    """Build (once per source hash) and load the strip kernel library.
    Fills `build_info` with the library path, build seconds and the
    compiler's -Xptxas -v report."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib, info = build_cuda_library(KERNEL_SRC, "libstrip_numeric",
                                       NVCC_FLAGS)
        lib.strip_numeric_f32.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 8 + [ctypes.c_void_p])
        lib.strip_numeric_f32.restype = ctypes.c_int
        build_info.update(info)
        _lib = lib
        return _lib


def _geometry(a_val, b_val, max_b, gm, block_rows):
    ntp, tm, tk = a_val.shape
    tn = b_val.shape[2] // max_b
    n_blocks = max(1, -(-gm // block_rows))
    return ntp, tm, tk, tn, n_blocks


def _check_operands(a_val, a_occ, b_val, b_occ, aptr, ak, slots, *,
                    gm, max_b, max_cblock, block_rows):
    dev = a_val.device
    for name, t, dt in (("a_val", a_val, torch.float32),
                        ("a_occ", a_occ, torch.bfloat16),
                        ("b_val", b_val, torch.float32),
                        ("b_occ", b_occ, torch.bfloat16),
                        ("aptr", aptr, torch.int32), ("ak", ak, torch.int32),
                        ("slots", slots, torch.int32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if a_val.dim() != 3 or b_val.dim() != 3:
        raise ValueError("a_val is (ntA_pad, tm, tk), b_val (gk, tk, max_b*tn)")
    ntp, tm, tk, tn, _ = _geometry(a_val, b_val, max_b, gm, block_rows)
    if (a_occ.shape != a_val.shape or b_occ.shape != b_val.shape
            or b_val.shape[1] != tk or b_val.shape[2] != max_b * tn
            or aptr.numel() != gm + 1 or ak.numel() != ntp
            or slots.numel() != ntp * max_b
            or min(gm, max_b, max_cblock, block_rows) < 1):
        raise ValueError(
            f"inconsistent strip operands: a {tuple(a_val.shape)}, "
            f"b {tuple(b_val.shape)}, aptr {aptr.numel()}, ak {ak.numel()}, "
            f"slots {slots.numel()}, gm={gm} max_b={max_b} "
            f"max_cblock={max_cblock} block_rows={block_rows}")


def strip_numeric_plain(a_val, a_occ, b_val, b_occ, aptr, ak, slots, *,
                        gm: int, max_b: int, max_cblock: int,
                        block_rows: int):
    """Plain PyTorch version of the strip kernel, on any device: batched
    A_g @ B-slice products over the plan's real (tile, y) pairs, then an
    index_add_ into the block-padded slots (the garbage slot max_cblock
    is dropped). Returns (c_val, c_cnt) f32, (n_blocks*max_cblock, tm, tn)."""
    ntp, tm, tk, tn, n_blocks = _geometry(a_val, b_val, max_b, gm,
                                          block_rows)
    dev = a_val.device
    c_val = torch.zeros(n_blocks * max_cblock, tm, tn, dtype=torch.float32,
                        device=dev)
    c_cnt = torch.zeros_like(c_val)
    s2 = slots.view(ntp, max_b).long()
    g, y = (s2 < max_cblock).nonzero(as_tuple=True)
    # tile-row of each A tile, then its block
    row = torch.searchsorted(aptr.long(), g, right=True) - 1
    dest = (row // block_rows) * max_cblock + s2[g, y]
    k = ak.long()[g]
    bv4 = b_val.view(b_val.shape[0], tk, max_b, tn)
    bo4 = b_occ.view(b_occ.shape[0], tk, max_b, tn)
    for lo in range(0, g.numel(), _PLAIN_CHUNK):
        sl = slice(lo, lo + _PLAIN_CHUNK)
        gg, kk, yy, dd = g[sl], k[sl], y[sl], dest[sl]
        c_val.index_add_(0, dd, torch.bmm(a_val[gg], bv4[kk, :, yy, :]))
        c_cnt.index_add_(0, dd, torch.bmm(a_occ[gg].float(),
                                          bo4[kk, :, yy, :].float()))
    return c_val, c_cnt


def strip_numeric(a_val, a_occ, b_val, b_occ, aptr, ak, slots, *,
                  gm: int, max_b: int, max_cblock: int, block_rows: int):
    """Strip SpGEMM numeric phase on the plan's operands (see
    ops/gustavson.py:StripArgs.to_device). Returns (c_val, c_cnt) f32 in
    the block-padded layout (n_blocks*max_cblock, tm, tn); every slot no
    pair reaches is zero. CPU tensors run strip_numeric_plain; CUDA
    tensors launch csrc/strip_numeric.cu."""
    kw = dict(gm=gm, max_b=max_b, max_cblock=max_cblock,
              block_rows=block_rows)
    _check_operands(a_val, a_occ, b_val, b_occ, aptr, ak, slots, **kw)
    if a_val.device.type == "cpu":
        strip_numeric.plain_launches += 1
        return strip_numeric_plain(a_val, a_occ, b_val, b_occ, aptr, ak,
                                   slots, **kw)
    if a_val.device.type != "cuda":
        raise ValueError(f"strip_numeric runs on cpu or cuda, not "
                         f"{a_val.device}")
    ntp, tm, tk, tn, n_blocks = _geometry(a_val, b_val, max_b, gm,
                                          block_rows)
    if (tm, tn) not in SUPPORTED_TILES or tk % TK_MULTIPLE:
        raise ValueError(f"strip kernel takes (tm, tn) in {SUPPORTED_TILES} "
                         f"and tk a multiple of {TK_MULTIPLE}, got ({tm}, "
                         f"{tn}) and tk={tk}")
    if n_blocks * max_cblock >= 2 ** 31:
        raise ValueError("strip kernel grid exceeds 2^31-1 C slots")
    lib = load_strip_kernel()
    c_val = torch.empty(n_blocks * max_cblock, tm, tn, dtype=torch.float32,
                        device=a_val.device)
    c_cnt = torch.empty_like(c_val)
    with torch.cuda.device(a_val.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.strip_numeric_f32(
            a_val.data_ptr(), a_occ.data_ptr(), b_val.data_ptr(),
            b_occ.data_ptr(), aptr.data_ptr(), ak.data_ptr(),
            slots.data_ptr(), c_val.data_ptr(), c_cnt.data_ptr(),
            gm, block_rows, max_b, max_cblock, n_blocks, tm, tk, tn, stream)
    if err != 0:
        raise RuntimeError(f"strip kernel launch failed: CUDA error {err}")
    strip_numeric.kernel_launches += 1
    return c_val, c_cnt


strip_numeric.kernel_launches = 0
strip_numeric.plain_launches = 0
