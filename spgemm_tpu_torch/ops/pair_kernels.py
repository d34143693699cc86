"""The hand-written CUDA kernel of the pair backend (backend="pallas") and
its plain PyTorch version.

`pair_accumulate_cuda` is the port of `spgemm_tpu/ops/pallas_kernels.py:
pair_accumulate_pallas` (:101), which reaches the Pallas kernel
`_pair_kernel` (:32): one program per C tile over its (A tile, B tile)
pairs. The kernel runs the strip kernel's tile pipeline
(`csrc/tile_pipeline.cuh`: persistent, TMA-fed, tf32 wgmma) on each C
tile's pair_ptr range. Its source, `csrc/pair_accumulate.cu`, says what
bounds the kernel on an H100 and what its design does about it.

For CPU tensors the wrapper runs the plain PyTorch version (the XLA
backend's ops/numeric.py:pair_accumulate over the same pairs); for CUDA
tensors it launches the kernel or raises. It never falls back. Both
accumulate in float32 only: float64 raises ValueError, as the Pallas
wrapper does. The occupancy planes may be float32 (the reference's
contract) or bfloat16 0/1, which is what the kernel reads: the wrapper
converts float32 planes to bfloat16 on the device, exactly, and the plain
version counts in float32 either way. The library is built with nvcc at
first use (never at import) into `spgemm_tpu_torch/_build/`; its build
key covers the source and the headers it includes.

Launch counters: `pair_accumulate_cuda.kernel_launches` counts kernel
launches and `pair_accumulate_cuda.plain_launches` dispatches to the plain
version. Only the wrapper increments them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from spgemm_tpu_torch.ops import numeric
from spgemm_tpu_torch.ops.kernels import build_cuda_library, chunk_grid

# the kernel's TMA maps need 16-byte row strides of bf16: A rows of other
# widths are padded to a multiple of this with zero columns
ROW_MULTIPLE = 8
OCC_DTYPES = (torch.float32, torch.bfloat16)

KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "pair_accumulate.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def load_pair_kernel():
    """Build (once per source hash) and load the pair kernel library.
    Fills `build_info` with the library path, build seconds and the
    compiler's -Xptxas -v report."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib, info = build_cuda_library(KERNEL_SRC, "libpair_accumulate",
                                       NVCC_FLAGS)
        lib.pair_accumulate_f32.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int64] * 5 + [ctypes.c_void_p])
        lib.pair_accumulate_f32.restype = ctypes.c_int
        build_info.update(info)
        _lib = lib
        return _lib


def pair_kernel_takes(tm: int, tn: int) -> bool:
    """Whether the pair kernel takes (tm, tk) A and (tk, tn) B tiles: tm %
    8 == 0 and tn % 128 == 0, the reference's gate
    (spgemm_tpu/ops/pallas_kernels.py:125), whose tk % 128 the port does
    not need (any tk: A's rows are padded to ROW_MULTIPLE); within the
    grid's chunk limits. It runs the strip kernel's h x 128 chunks
    (ops/kernels.py:chunk_grid)."""
    return chunk_grid(tm, tn) is not None


def check_pair_dtype(dtype) -> None:
    """The pair kernel accumulates in float32 only (the reference's
    Pallas wrapper also allows bfloat16; the port does not yet)."""
    if dtype != torch.float32:
        raise ValueError(f"the pair kernel (backend='pallas') accumulates in "
                         f"float32, got {dtype}; use backend='xla' for "
                         f"float64")


def _check_operands(a_val, a_occ, b_val, b_occ, pa, pb, pair_ptr, *,
                    num_segments):
    check_pair_dtype(a_val.dtype)
    dev = a_val.device
    for name, t, dts in (("a_val", a_val, (torch.float32,)),
                         ("a_occ", a_occ, OCC_DTYPES),
                         ("b_val", b_val, (torch.float32,)),
                         ("b_occ", b_occ, OCC_DTYPES),
                         ("pa", pa, (torch.int32,)), ("pb", pb, (torch.int32,)),
                         ("pair_ptr", pair_ptr, (torch.int32,))):
        if t.dtype not in dts or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous tensor of "
                             f"{' or '.join(map(str, dts))} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if (a_val.dim() != 3 or b_val.dim() != 3 or a_occ.shape != a_val.shape
            or b_occ.shape != b_val.shape or b_val.shape[1] != a_val.shape[2]
            or pb.numel() != pa.numel()
            or pair_ptr.numel() != num_segments + 1 or num_segments < 0):
        raise ValueError(
            f"inconsistent pair operands: a {tuple(a_val.shape)}, a_occ "
            f"{tuple(a_occ.shape)}, b {tuple(b_val.shape)}, b_occ "
            f"{tuple(b_occ.shape)}, pa {pa.numel()}, pb {pb.numel()}, "
            f"pair_ptr {pair_ptr.numel()}, num_segments={num_segments}")


def pair_accumulate_plain(a_val, a_occ, b_val, b_occ, pa, pb, pair_ptr, *,
                          num_segments: int):
    """Plain PyTorch version of the pair kernel, on any device: the XLA
    backend's pair_accumulate over the same pairs, each pair's segment
    read off pair_ptr; counts in float32 whatever the occupancy planes'
    dtype. Returns (c_val, c_cnt) f32, (num_segments, tm, tn); a C tile
    with no pairs is zero."""
    seg = torch.repeat_interleave(
        torch.arange(num_segments, device=a_val.device),
        torch.diff(pair_ptr.long()))
    return numeric.pair_accumulate(a_val, a_occ, b_val, b_occ, pa, pb, seg,
                                   num_segments=num_segments)


def pair_accumulate_cuda(a_val, a_occ, b_val, b_occ, pa, pb, pair_ptr, *,
                         num_segments: int):
    """Per-C-tile pair accumulation: for every C tile i, c_val[i] = sum of
    a_val[pa[j]] @ b_val[pb[j]] and c_cnt[i] the same over the occupancy
    planes, j in [pair_ptr[i], pair_ptr[i+1]). a_val (ntA, tm, tk) and
    b_val (ntB, tk, tn) are float32, their 0/1 occupancy planes float32
    or bfloat16. Returns (c_val, c_cnt) f32, (num_segments, tm, tn). CPU
    tensors run pair_accumulate_plain; CUDA tensors launch
    csrc/pair_accumulate.cu, with the occupancy converted to bfloat16 and
    A's rows padded to a multiple of ROW_MULTIPLE columns first where
    they are not (both on the device, inside the call)."""
    _check_operands(a_val, a_occ, b_val, b_occ, pa, pb, pair_ptr,
                    num_segments=num_segments)
    if a_val.device.type == "cpu":
        pair_accumulate_cuda.plain_launches += 1
        return pair_accumulate_plain(a_val, a_occ, b_val, b_occ, pa, pb,
                                     pair_ptr, num_segments=num_segments)
    if a_val.device.type != "cuda":
        raise ValueError(f"pair_accumulate_cuda runs on cpu or cuda, not "
                         f"{a_val.device}")
    _, tm, tk = a_val.shape
    tn = b_val.shape[2]
    if not pair_kernel_takes(tm, tn):
        raise ValueError(f"the pair kernel takes tm % 8 == 0 and tn % 128 "
                         f"== 0 (at most 65535 chunks of each), got ({tm}, "
                         f"{tn})")
    if num_segments >= 2 ** 31:
        raise ValueError("pair kernel grid exceeds 2^31-1 C tiles")
    lib = load_pair_kernel()
    c_val = torch.empty(num_segments, tm, tn, dtype=torch.float32,
                        device=a_val.device)
    c_cnt = torch.empty_like(c_val)
    if num_segments == 0:  # an empty grid: nothing to launch
        return c_val, c_cnt
    a_occ = a_occ.to(torch.bfloat16)  # exact for 0/1; no copy if bf16
    b_occ = b_occ.to(torch.bfloat16)
    lda = -(-tk // ROW_MULTIPLE) * ROW_MULTIPLE
    if lda != tk:  # zero columns up to a 16-byte row of bf16
        pad = (0, lda - tk)
        a_val = torch.nn.functional.pad(a_val, pad)
        a_occ = torch.nn.functional.pad(a_occ, pad)
    if any(t.data_ptr() % 16 for t in (a_val, a_occ, b_val, b_occ)):
        raise ValueError("the pair kernel loads its planes by TMA: the value "
                         "and occupancy planes must start 16-byte aligned")
    with torch.cuda.device(a_val.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pair_accumulate_f32(
            a_val.data_ptr(), a_occ.data_ptr(), b_val.data_ptr(),
            b_occ.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            pair_ptr.data_ptr(), c_val.data_ptr(), c_cnt.data_ptr(),
            num_segments, tm, tk, tn, lda, stream)
    if err != 0:
        raise RuntimeError(f"pair kernel launch failed: CUDA error {err}")
    pair_accumulate_cuda.kernel_launches += 1
    return c_val, c_cnt


pair_accumulate_cuda.kernel_launches = 0
pair_accumulate_cuda.plain_launches = 0
