"""The hand-written CUDA kernel of the Ozaki strip route and its plain
PyTorch version.

`ozaki_strip_numeric` is the port of `spgemm_tpu/ops/pallas_kernels.py:
ozaki_strip_pallas` (:1137), which reaches the Pallas kernel
`_ozaki_strip_kernel_factory` (:971). Its source, `csrc/ozaki_strip.cu`,
says what the kernel computes, what bounds it on an H100 and what its
design does about it: int8 wgmma on the transposed product C^T = B^T A^T,
fed by TMA from a producer warpgroup to two consumer warpgroups, one
persistent CTA per SM. It reads its pairs from the plan's `ak` and
`slots` (as csrc/strip_numeric.cu does), not from the TPU kernel's
`kmin`/`meta`.

For CPU tensors the wrapper runs the plain PyTorch version; for CUDA
tensors it launches the kernel or raises. It never falls back. Both
versions sum exact int32 group products and reduce them with the same
TwoSum sequence (the kernel is built with --fmad=false), so h, m, l and
the counts are bit-equal. The kernel takes every tm % 8 == 0, tn % 128
== 0 tile (`ozaki_kernel_takes`) as items of 128 columns and h rows of a
C slot (h 32, 16 or 8; 16 or 8 with all 15 pair groups: `ozaki_grid`).
int8 wgmma reads both operands K-major, so each call first writes the
K-major copies of bv8 and b_occ (`k_major_b_plain` is that step's plain
version) into scratch the wrapper allocates; the copy's time is part of
the call's. `ozaki_strip_passes` runs the kernel once per value pass
over one geometry (the auto router's hi/lo split, ops/ozaki.py), with
the planes and the scratch allocated once. The library is built with
nvcc at first use (never at import) into `spgemm_tpu_torch/_build/`.

Launch counters: `ozaki_strip_numeric.kernel_launches` counts kernel
launches and `ozaki_strip_numeric.plain_launches` dispatches to the plain
version. Only the wrapper increments them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

from spgemm_tpu_torch.ops.kernels import build_cuda_library, chunk_grid

# chunk heights the CUDA kernel is instantiated for (the wgmma N of one
# slice; all 15 pair groups take 16 rows at most) and its columns per item
# (two consumer warpgroups of 64, wgmma's M)
OZAKI_HEIGHTS = (32, 16, 8)
OZAKI_WIDE_HEIGHTS = (16, 8)
OZAKI_COLS = 128
TK_MULTIPLE = 16    # k32 int8 products over 16-byte runs of bf16 counts
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
            [ctypes.c_void_p] * 13 + [ctypes.c_int64] * 14
            + [ctypes.c_void_p])
        lib.ozaki_strip_f32.restype = ctypes.c_int
        build_info.update(info)
        _lib = lib
        return _lib


def ozaki_grid(tm: int, tn: int, wide: bool = False):
    """(128-column chunks, [(h, row_base, n)]) of a tm x tn tile: the
    items of a C slot, one launch per height (csrc/ozaki_strip.cu: row
    chunks of 32, 16 and 8 rows, as ops/kernels.py:row_parts picks them;
    16 and 8 with all 15 pair groups, `wide`); None where the kernel does
    not take the tile."""
    grid = chunk_grid(tm, tn, OZAKI_WIDE_HEIGHTS if wide else OZAKI_HEIGHTS,
                      OZAKI_COLS)
    return None if grid is None else grid[::-1]


def ozaki_kernel_takes(tm: int, tk: int, tn: int) -> bool:
    """Whether the Ozaki strip kernel takes (tm, tk) A and (tk, tn) B
    tiles: tm % 8 == 0 and tn % 128 == 0, the tiles the reference's Ozaki
    strip kernel runs (spgemm_tpu/ops/ozaki.py:770-797 adds only its VMEM
    budget), and tk % 16 == 0; within the grid's chunk limits."""
    return (ozaki_grid(tm, tn) is not None and tk > 0
            and tk % TK_MULTIPLE == 0)


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


def k_major_b_plain(bv8, b_occ):
    """The K-major copies of B the kernel reads (its transpose step's plain
    version): bv8 (gk, tk, sb*max_b*tn) -> (gk, sb*max_b*tn, tk) and b_occ
    (gk, tk, max_b*tn) -> (gk, max_b*tn, tk), each column's tk values
    contiguous."""
    return (bv8.transpose(1, 2).contiguous(),
            b_occ.transpose(1, 2).contiguous())


def _check_card_operands(av8, a_occ, bv8, b_occ, kw: dict) -> None:
    """The kernel's own limits beside _check_operands: the tiles it takes,
    16-byte aligned planes, and item and TMA row counts under 2^31."""
    ntp, _, tm, tk, tn, n_blocks, _, _ = _geometry(
        av8, a_occ, b_occ, **{k: kw[k] for k in (
            "gm", "max_b", "block_rows", "sa", "sb", "pmax")})
    if not ozaki_kernel_takes(tm, tk, tn):
        raise ValueError(f"Ozaki strip kernel takes tm % 8 == 0, tn % 128 "
                         f"== 0 (at most 65535 chunks of each) and tk % "
                         f"{TK_MULTIPLE} == 0, got ({tm}, {tn}), tk={tk}")
    if any(t.data_ptr() % 16 for t in (av8, a_occ, bv8, b_occ)):
        raise ValueError("the Ozaki strip kernel copies 16-byte runs: av8, "
                         "a_occ, bv8 and b_occ must start 16-byte aligned")
    if (n_blocks * kw["max_cblock"] * (tn // OZAKI_COLS) * (tm // 8)
            >= 2 ** 31 or ntp * tm >= 2 ** 31 or bv8.shape[2] >= 2 ** 31):
        raise ValueError("Ozaki strip kernel items or TMA rows exceed "
                         "2^31-1")


def _card_buffers(a_occ, b_occ, bv8_cols: int, *, gm: int, max_b: int,
                  max_cblock: int, block_rows: int, **_):
    """(the four f32 output planes, the K-major scratch of a bv8 of up to
    `bv8_cols` columns, that of b_occ) on a_occ's card."""
    dev = a_occ.device
    tm, tk = a_occ.shape[1], a_occ.shape[2]
    gk, tn = b_occ.shape[0], b_occ.shape[2] // max_b
    n_slots = max(1, -(-gm // block_rows)) * max_cblock
    planes = [torch.empty(n_slots, tm, tn, dtype=torch.float32, device=dev)
              for _ in range(4)]
    bt8 = torch.empty(gk * bv8_cols * tk, dtype=torch.int8, device=dev)
    bt_occ = torch.empty(gk, b_occ.shape[2], tk, dtype=torch.bfloat16,
                         device=dev)
    return planes, bt8, bt_occ


def _launch(av8, a_occ, bv8, b_occ, aptr, ak, slots, planes, bt8, bt_occ,
            kw: dict) -> None:
    """One launch of csrc/ozaki_strip.cu into `planes`: the kernel first
    writes the K-major copies of bv8 and b_occ into bt8 and bt_occ."""
    ntp, stack_rows, tm, tk, tn, n_blocks, pmax, _ = _geometry(
        av8, a_occ, b_occ, **{k: kw[k] for k in (
            "gm", "max_b", "block_rows", "sa", "sb", "pmax")})
    lib = load_ozaki_kernel()
    with torch.cuda.device(av8.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ozaki_strip_f32(
            av8.data_ptr(), a_occ.data_ptr(), bv8.data_ptr(),
            b_occ.data_ptr(), aptr.data_ptr(), ak.data_ptr(),
            slots.data_ptr(), bt8.data_ptr(), bt_occ.data_ptr(),
            *[p.data_ptr() for p in planes],
            kw["gm"], kw["block_rows"], kw["max_b"], kw["max_cblock"],
            n_blocks, tm, tk, tn, stack_rows, kw["sa"], kw["sb"], pmax, ntp,
            bv8.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"Ozaki strip kernel launch failed: CUDA error "
                           f"{err}")
    ozaki_strip_numeric.kernel_launches += 1


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
    _check_card_operands(av8, a_occ, bv8, b_occ, kw)
    planes, bt8, bt_occ = _card_buffers(a_occ, b_occ, bv8.shape[2], **kw)
    _launch(av8, a_occ, bv8, b_occ, aptr, ak, slots, planes, bt8, bt_occ, kw)
    return tuple(planes)


def ozaki_strip_passes(a_occ, b_occ, aptr, ak, slots, passes, *, gm: int,
                       max_b: int, max_cblock: int, block_rows: int):
    """The Ozaki strip kernel over one geometry for several value passes
    (ops/ozaki.py's hi/lo split): `passes` lists (av8, bv8, sa, sb, pmax)
    per pass, each with the shared a_occ, b_occ, aptr, ak and slots.
    Yields each pass's (c_h, c_m, c_l, c_cnt) in turn, as
    ozaki_strip_numeric returns them. On CUDA the four output planes and
    the K-major scratch are allocated once, for the widest bv8, and every
    launch writes over them: the caller queues its reads of one pass's
    planes before it asks for the next, and stream order does the rest.
    CPU tensors run the plain version, fresh planes each pass."""
    geom = dict(gm=gm, max_b=max_b, max_cblock=max_cblock,
                block_rows=block_rows)
    bufs = None
    for av8, bv8, sa, sb, pmax in passes:
        kw = dict(geom, sa=sa, sb=sb, pmax=pmax)
        if a_occ.device.type != "cuda":
            yield ozaki_strip_numeric(av8, a_occ, bv8, b_occ, aptr, ak,
                                      slots, **kw)
            continue
        _check_operands(av8, a_occ, bv8, b_occ, aptr, ak, slots, **kw)
        _check_card_operands(av8, a_occ, bv8, b_occ, kw)
        if bufs is None:
            bufs = _card_buffers(a_occ, b_occ,
                                 max(p[1].shape[2] for p in passes), **kw)
        _launch(av8, a_occ, bv8, b_occ, aptr, ak, slots, *bufs, kw)
        yield tuple(bufs[0])


ozaki_strip_numeric.kernel_launches = 0
ozaki_strip_numeric.plain_launches = 0
