"""Hand-written CUDA kernel of the dynamic-gather probe and its plain
PyTorch version.

`take_along_blocks` is the port of the Pallas kernel in the JAX repo's
`tools/probe_dyngather.py:make_gather_kernel` (:30, `pl.pallas_call`
:40): `take_along_axis` on each block of `blk_rows` rows of an (R, C)
float32 array, along axis 1 (within a row) or axis 0 (within a column of
the block). `csrc/dyngather.cu`'s header says how the kernel stages a
row or a column slice and what bounds it on an H100.

For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches the kernel or raises. It never falls back. A gather is exact,
so on the card the kernel is bit-equal to the plain version. The
library is built with nvcc at first use (never at import) into
`spgemm_tpu_torch/_build/`, keyed on a hash of the source and flags.

Launch counters: `take_along_blocks.kernel_launches` counts kernel
launches and `.plain_launches` dispatches to the plain version. Only the
wrapper increments them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from spgemm_tpu_torch.ops.kernels import build_cuda_library

MAX_ROW_LEN = 1024      # axis 1: a warp stages one row of C floats
MAX_BLK_ROWS = 1024     # axis 0: a CTA stages blk_rows x 32 floats

KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "dyngather.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def load_gather_kernel():
    """Build (once per source hash) and load the gather kernel library.
    Fills `build_info` with the library path, build seconds and the
    compiler's -Xptxas -v report."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib, info = build_cuda_library(KERNEL_SRC, "libdyngather", NVCC_FLAGS)
        lib.take_along_blocks_f32.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_int,
                                                            ctypes.c_int64,
                                                            ctypes.c_void_p])
        lib.take_along_blocks_f32.restype = ctypes.c_int
        build_info.update(info)
        _lib = lib
        return _lib


def _check_operands(x, idx, axis: int, blk_rows: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: need a contiguous 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if idx.dtype != torch.int32 or idx.shape != x.shape \
            or idx.device != x.device or not idx.is_contiguous():
        raise ValueError(f"idx: need a contiguous int32 {tuple(x.shape)} "
                         f"tensor on {x.device}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1: {axis}")
    if blk_rows < 1 or x.shape[0] % blk_rows:
        raise ValueError(f"blk_rows={blk_rows} must divide R={x.shape[0]} "
                         f"(the blocks cover every row)")


def take_along_blocks_plain(x, idx, *, axis: int, blk_rows: int):
    """Plain PyTorch version: torch.take_along_dim on the (R / blk_rows,
    blk_rows, C) view, on any device. On CPU tensors it checks the index
    contract, 0 <= idx < C (axis 1) or < blk_rows (axis 0), and raises
    ValueError outside it."""
    _check_operands(x, idx, axis, blk_rows)
    r, c = x.shape
    limit = c if axis == 1 else blk_rows
    if x.device.type == "cpu" and idx.numel() \
            and (int(idx.min()) < 0 or int(idx.max()) >= limit):
        raise ValueError(f"indices must lie in [0, {limit}) along axis "
                         f"{axis}: got [{int(idx.min())}, {int(idx.max())}]")
    shape = (r // blk_rows, blk_rows, c)
    return torch.take_along_dim(x.view(shape), idx.view(shape).long(),
                                dim=axis + 1).view(r, c)


def gather_kernel_takes(shape, *, axis: int, blk_rows: int) -> bool:
    """Whether the card's kernel takes this (R, C) block gather: R a
    multiple of blk_rows, and C <= MAX_ROW_LEN (axis 1) or blk_rows <=
    MAX_BLK_ROWS (axis 0)."""
    r, c = shape
    if blk_rows < 1 or r % blk_rows:
        return False
    return c <= MAX_ROW_LEN if axis == 1 else blk_rows <= MAX_BLK_ROWS


def take_along_blocks(x, idx, *, axis: int, blk_rows: int):
    """out = take_along_axis(x_blk, idx_blk, axis) for each block of
    `blk_rows` rows of x (R, C) float32 with idx (R, C) int32. CPU
    tensors run take_along_blocks_plain; CUDA tensors launch
    csrc/dyngather.cu (C <= 1024 on axis 1, blk_rows <= 1024 on axis 0;
    ValueError outside that). Returns (R, C) float32."""
    _check_operands(x, idx, axis, blk_rows)
    if x.device.type == "cpu":
        take_along_blocks.plain_launches += 1
        return take_along_blocks_plain(x, idx, axis=axis, blk_rows=blk_rows)
    if x.device.type != "cuda":
        raise ValueError(f"take_along_blocks runs on cpu or cuda, not "
                         f"{x.device}")
    if not gather_kernel_takes(x.shape, axis=axis, blk_rows=blk_rows):
        raise ValueError(
            f"the gather kernel takes C <= {MAX_ROW_LEN} on axis 1 and "
            f"blk_rows <= {MAX_BLK_ROWS} on axis 0: got {tuple(x.shape)}, "
            f"axis {axis}, blk_rows {blk_rows}")
    lib = load_gather_kernel()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.take_along_blocks_f32(x.data_ptr(), idx.data_ptr(),
                                        out.data_ptr(), x.shape[0],
                                        x.shape[1], axis, blk_rows, stream)
    if err != 0:
        raise RuntimeError(f"take_along_blocks launch failed: CUDA error "
                           f"{err}")
    take_along_blocks.kernel_launches += 1
    return out


take_along_blocks.kernel_launches = 0
take_along_blocks.plain_launches = 0
