"""The hand-written CUDA kernel of the Ozaki strip route and its plain
PyTorch version.

`ozaki_strip_numeric` is the port of `spgemm_tpu/ops/pallas_kernels.py:
ozaki_strip_pallas` (:1137), which reaches the Pallas kernel
`_ozaki_strip_kernel_factory` (:971). Its source, `csrc/ozaki_strip.cu`,
says what the kernel computes, what bounds it on an H100 and what its
design does about it. It reads its pairs from the plan's `ak` and `slots`
(as csrc/strip_numeric.cu does), not from the TPU kernel's `kmin`/`meta`.

For CPU tensors the wrapper runs the plain PyTorch version; for CUDA
tensors it launches the kernel or raises. It never falls back. Both
versions sum exact int32 group products and reduce them with the same
TwoSum sequence (the kernel is built with --fmad=false), so h, m, l and
the counts are bit-equal. The kernel has an instantiation for up to 8
pair groups (the plans' usual pmax 7) and one for all 15; the launch
picks by the plan's group count. The library is built with nvcc at first
use (never at import) into `spgemm_tpu_torch/_build/`.

Launch counters: `ozaki_strip_numeric.kernel_launches` counts kernel
launches and `ozaki_strip_numeric.plain_launches` dispatches to the plain
version. Only the wrapper increments them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from spgemm_tpu_torch.ops.kernels import build_cuda_library

# (tm, tn) tile shapes the CUDA kernel is instantiated for; tk % 16 == 0
OZAKI_TILES = ((16, 128), (32, 128))
MAX_SLICES = 8      # 7 bits/slice * 8 = 56 >= f64's 53 significand bits
# bytes of f64 temporaries the plain version allows per chunk of pairs
_PLAIN_CHUNK_BYTES = 1 << 30

KERNEL_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "ozaki_strip.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def load_ozaki_kernel():
    """Build (once per source hash) and load the Ozaki strip kernel
    library. Fills `build_info` with the library path, build seconds and
    the compiler's -Xptxas -v report."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib, info = build_cuda_library(KERNEL_SRC, "libozaki_strip",
                                       NVCC_FLAGS)
        lib.ozaki_strip_f32.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int64] * 12
            + [ctypes.c_void_p])
        lib.ozaki_strip_f32.restype = ctypes.c_int
        build_info.update(info)
        _lib = lib
        return _lib


def _geometry(av8, a_occ, b_occ, *, gm, max_b, block_rows, sa, sb, pmax):
    """(ntp, stack_rows, tm, tk, tn, n_blocks, pmax, n_groups)."""
    ntp, stack_rows, tk = av8.shape
    tm = a_occ.shape[1]
    tn = b_occ.shape[2] // max_b
    n_blocks = max(1, -(-gm // block_rows))
    if pmax is None:
        pmax = sa + sb - 2
    return (ntp, stack_rows, tm, tk, tn, n_blocks, pmax,
            min(sa + sb - 1, pmax + 1))


def _check_operands(av8, a_occ, bv8, b_occ, aptr, ak, slots, *, gm, max_b,
                    max_cblock, block_rows, sa, sb, pmax):
    dev = av8.device
    for name, t, dt in (("av8", av8, torch.int8),
                        ("a_occ", a_occ, torch.bfloat16),
                        ("bv8", bv8, torch.int8),
                        ("b_occ", b_occ, torch.bfloat16),
                        ("aptr", aptr, torch.int32), ("ak", ak, torch.int32),
                        ("slots", slots, torch.int32)):
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {t.dtype} on {t.device}")
    if av8.dim() != 3 or a_occ.dim() != 3 or bv8.dim() != 3 \
            or b_occ.dim() != 3:
        raise ValueError("av8 is (ntA_pad, stack_rows, tk), a_occ (ntA_pad, "
                         "tm, tk), bv8 (gk_pad, tk, sb*max_b*tn), b_occ "
                         "(gk_pad, tk, max_b*tn)")
    if not (1 <= sa <= MAX_SLICES and 1 <= sb <= MAX_SLICES) \
            or (pmax is not None and pmax < 0):
        raise ValueError(f"need 1 <= sa, sb <= {MAX_SLICES} and pmax >= 0: "
                         f"sa={sa} sb={sb} pmax={pmax}")
    ntp, stack_rows, tm, tk, tn, _, _, _ = _geometry(
        av8, a_occ, b_occ, gm=gm, max_b=max_b, block_rows=block_rows, sa=sa,
        sb=sb, pmax=pmax)
    if (a_occ.shape != (ntp, tm, tk) or stack_rows < sa * tm
            or b_occ.shape[2] != max_b * tn
            or bv8.shape != (b_occ.shape[0], tk, sb * max_b * tn)
            or b_occ.shape[1] != tk
            or aptr.numel() != gm + 1 or ak.numel() != ntp
            or slots.numel() != ntp * max_b
            or min(gm, max_b, max_cblock, block_rows, tn) < 1):
        raise ValueError(
            f"inconsistent Ozaki strip operands: av8 {tuple(av8.shape)}, "
            f"a_occ {tuple(a_occ.shape)}, bv8 {tuple(bv8.shape)}, b_occ "
            f"{tuple(b_occ.shape)}, aptr {aptr.numel()}, ak {ak.numel()}, "
            f"slots {slots.numel()}, gm={gm} max_b={max_b} "
            f"max_cblock={max_cblock} block_rows={block_rows} sa={sa} "
            f"sb={sb}")


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def triple_float_reduce(groups: torch.Tensor):
    """(h, m, l) f32 from int32 group sums (n, n_groups, tm, tn): the
    exact split mh = f32(M_p), ml = f32(M_p - i32(mh)), both scaled by
    2^(-7p) and added by cascaded TwoSum, in the reference's order
    (pallas_kernels.py:1096-1119)."""
    shape = (groups.shape[0],) + tuple(groups.shape[2:])
    h = torch.zeros(shape, dtype=torch.float32, device=groups.device)
    m = torch.zeros_like(h)
    low = torch.zeros_like(h)
    for p in range(groups.shape[1]):
        mp = groups[:, p]
        mh = mp.to(torch.float32)
        ml = (mp - mh.to(torch.int32)).to(torch.float32)
        scale = 2.0 ** (-7 * p)
        for x in (mh * scale, ml * scale):
            h, e = _two_sum(h, x)
            m, e2 = _two_sum(m, e)
            low = low + e2
    return h, m, low


def ozaki_strip_numeric_plain(av8, a_occ, bv8, b_occ, aptr, ak, slots, *,
                              gm: int, max_b: int, max_cblock: int,
                              block_rows: int, sa: int, sb: int,
                              pmax: int | None = None):
    """Plain PyTorch version of the Ozaki strip kernel, on any device.

    For the plan's real (tile, y) pairs, in chunks: the slice products in
    float64 bmm (exact: every partial sum is an integer below 2^31, far
    under 2^53), cast to int32, summed into pair groups p = s + t <= pmax
    and index_add_ed into the block-padded slots (the garbage slot
    max_cblock is dropped); the counts likewise in f32 from the 0/1
    occupancy planes. Then the triple-float reduce. Returns (c_h, c_m,
    c_l, c_cnt) f32, (n_blocks*max_cblock, tm, tn)."""
    ntp, stack_rows, tm, tk, tn, n_blocks, pmax, n_groups = _geometry(
        av8, a_occ, b_occ, gm=gm, max_b=max_b, block_rows=block_rows, sa=sa,
        sb=sb, pmax=pmax)
    dev = av8.device
    n_slots = n_blocks * max_cblock
    acc = torch.zeros(n_slots, n_groups, tm, tn, dtype=torch.int32,
                      device=dev)
    c_cnt = torch.zeros(n_slots, tm, tn, dtype=torch.float32, device=dev)
    s2 = slots.view(ntp, max_b).long()
    g, y = (s2 < max_cblock).nonzero(as_tuple=True)
    row = torch.searchsorted(aptr.long(), g, right=True) - 1
    dest = (row // block_rows) * max_cblock + s2[g, y]
    k = ak.long()[g]
    bv5 = bv8.view(bv8.shape[0], tk, sb, max_b, tn)
    bo4 = b_occ.view(b_occ.shape[0], tk, max_b, tn)
    combos = [(s, p - s) for p in range(n_groups) for s in range(sa)
              if 0 <= p - s < sb]
    pair_bytes = 8 * (sa * tm * tk + tk * sb * tn + 2 * sa * tm * sb * tn)
    chunk = max(1, _PLAIN_CHUNK_BYTES // pair_bytes)
    for lo in range(0, g.numel(), chunk):
        sl = slice(lo, lo + chunk)
        gg, kk, yy, dd = g[sl], k[sl], y[sl], dest[sl]
        n = gg.numel()
        a_c = av8[gg, : sa * tm].to(torch.float64)           # (n, sa*tm, tk)
        b_c = bv5[kk, :, :, yy, :].reshape(n, tk, sb * tn).to(torch.float64)
        prod = torch.bmm(a_c, b_c).to(torch.int32).view(n, sa, tm, sb, tn)
        del a_c, b_c
        grp = torch.zeros(n, n_groups, tm, tn, dtype=torch.int32, device=dev)
        for s, t in combos:
            grp[:, s + t] += prod[:, s, :, t, :]
        del prod
        acc.index_add_(0, dd, grp)
        c_cnt.index_add_(0, dd, torch.bmm(a_occ[gg].float(),
                                          bo4[kk, :, yy, :].float()))
    c_h, c_m, c_l = triple_float_reduce(acc)
    return c_h, c_m, c_l, c_cnt


def ozaki_strip_numeric(av8, a_occ, bv8, b_occ, aptr, ak, slots, *,
                        gm: int, max_b: int, max_cblock: int,
                        block_rows: int, sa: int, sb: int,
                        pmax: int | None = None):
    """Fused Ozaki strip numeric phase on the plan's operands (see
    ops/ozaki.py:OzakiStripPlan.to_device). Returns (c_h, c_m, c_l, c_cnt)
    f32 in the block-padded layout (n_blocks*max_cblock, tm, tn): the
    unscaled triple-float sums sum_p M_p 2^(-7p) and the structural counts.
    pmax truncates pair groups p = s + t (None keeps all). CPU tensors run
    ozaki_strip_numeric_plain; CUDA tensors launch csrc/ozaki_strip.cu."""
    kw = dict(gm=gm, max_b=max_b, max_cblock=max_cblock,
              block_rows=block_rows, sa=sa, sb=sb, pmax=pmax)
    _check_operands(av8, a_occ, bv8, b_occ, aptr, ak, slots, **kw)
    if av8.device.type == "cpu":
        ozaki_strip_numeric.plain_launches += 1
        return ozaki_strip_numeric_plain(av8, a_occ, bv8, b_occ, aptr, ak,
                                         slots, **kw)
    if av8.device.type != "cuda":
        raise ValueError(f"ozaki_strip_numeric runs on cpu or cuda, not "
                         f"{av8.device}")
    ntp, stack_rows, tm, tk, tn, n_blocks, pmax, _ = _geometry(
        av8, a_occ, b_occ, gm=gm, max_b=max_b, block_rows=block_rows, sa=sa,
        sb=sb, pmax=pmax)
    if (tm, tn) not in OZAKI_TILES or tk % 16:
        raise ValueError(f"Ozaki strip kernel takes (tm, tn) in "
                         f"{OZAKI_TILES} and tk % 16 == 0, got ({tm}, {tn}), "
                         f"tk={tk}")
    if n_blocks * max_cblock >= 2 ** 31:
        raise ValueError("Ozaki strip kernel grid exceeds 2^31-1 C slots")
    if any(t.data_ptr() % 16 for t in (av8, a_occ, bv8, b_occ)):
        raise ValueError("the Ozaki strip kernel copies 16-byte runs: av8, "
                         "a_occ, bv8 and b_occ must start 16-byte aligned")
    lib = load_ozaki_kernel()
    planes = [torch.empty(n_blocks * max_cblock, tm, tn, dtype=torch.float32,
                          device=av8.device) for _ in range(4)]
    with torch.cuda.device(av8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ozaki_strip_f32(
            av8.data_ptr(), a_occ.data_ptr(), bv8.data_ptr(),
            b_occ.data_ptr(), aptr.data_ptr(), ak.data_ptr(),
            slots.data_ptr(), *[p.data_ptr() for p in planes],
            gm, block_rows, max_b, max_cblock, n_blocks, tm, tk, tn,
            stack_rows, sa, sb, pmax, stream)
    if err != 0:
        raise RuntimeError(f"Ozaki strip kernel launch failed: CUDA error "
                           f"{err}")
    ozaki_strip_numeric.kernel_launches += 1
    return tuple(planes)


ozaki_strip_numeric.kernel_launches = 0
ozaki_strip_numeric.plain_launches = 0
