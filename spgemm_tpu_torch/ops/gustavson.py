"""Gustavson-by-k slab route and the strip SpGEMM planner and numeric
launcher (port of `spgemm_tpu/ops/gustavson.py`).

The slab route (`GustavsonPlan`, `gustavson_numeric`, the "gustavson"
backend) groups tile pairs by the inner tile index k: A's tiles of
column k stacked vertically, B's tiles of row k horizontally, so every
pair product of one k is one dense matmul. The plan is NumPy, array for
array the JAX package's; the numeric step is torch ops: one `bmm` for
the values and one for the 0/1 counts, a permute to pair order and one
`index_add_` into the C tiles (padding slots go to a sentinel tile).
It runs any tile shape and dtype; the strip kernel does not.

The strip plan is built on the host exactly as the JAX package builds it
(same native symbolic, same packing, same windowed-B decision rule), so
the two packages run from identical plans. What differs:

* the TPU gates are gone: Mosaic 128-alignment, the SMEM slot-table and
  the VMEM scratch budgets (`gustavson.py:585-626,688-693,753-785`). The
  port kernel's own limits replace them (`check_strip_feasible`): on
  CUDA, tm % 8 == 0, tn % 128 == 0 (the reference's alignment rule) and
  tk % 8 == 0 (ops/kernels.py:strip_kernel_takes); the kernel's shared
  memory does not grow with the plan;
* the windowed plan (kwin set) keeps its padded B but not the TPU
  kernel's `kmin` window starts or `meta` rows: the CUDA kernel reads
  B slabs by ak and its pairs from slots, so both plan shapes run
  through one kernel;
* occupancy planes are uint16 arrays holding bfloat16 bits on the host
  and torch.bfloat16 on the device;
* the compaction epilogue (`strip_compact_device`, XLA in the JAX
  package) is torch ops.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from spgemm_tpu_torch.models.csr import INDEX_DTYPE
from spgemm_tpu_torch.models.tile import MASK_BITS, MASK_DTYPE, TileMat, cdiv
from spgemm_tpu_torch.ops import kernels
from spgemm_tpu_torch.utils.timing import count_bytes, resolve_device, span

BF16_ONE = np.uint16(0x3F80)


def _u16_to_bf16(u16: np.ndarray) -> torch.Tensor:
    """uint16 bfloat16 bit patterns -> torch.bfloat16 (shares memory)."""
    return torch.from_numpy(np.ascontiguousarray(u16).view(np.int16)).view(
        torch.bfloat16)


@contextlib.contextmanager
def full_fp32():
    """f32 matmuls on CUDA run in full FP32 inside the block, never TF32,
    whatever the caller switched on globally: the JAX package multiplies
    at Precision.HIGHEST. The caller's setting is restored on exit."""
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = prev


def product_dtype(dtype: torch.dtype, acc_dtype) -> torch.dtype:
    """dtype a product of `dtype` operands is computed in so that it can
    be accumulated in `acc_dtype` (None: the operands' own): the wider
    of the two, as a matmul with preferred_element_type=acc_dtype."""
    return torch.promote_types(dtype, acc_dtype or dtype)


# --- slab route (backend "gustavson") ---------------------------------------

@dataclasses.dataclass
class GustavsonPlan:
    """Host plan of the slab route: padded k-group slabs and the scatter
    segment map."""

    gk: int              # inner grid dimension (A tile-cols == B tile-rows)
    max_a: int           # max A tiles in any column k
    max_b: int           # max B tiles in any row k
    tm: int
    tk: int
    tn: int
    nt_c: int            # candidate C tiles
    ctrow: np.ndarray    # (nt_c,)
    ctcol: np.ndarray
    num_pairs: int
    a3_val: np.ndarray | None  # (gk, max_a*tm, tk) stacked A slabs
    a3_occ: np.ndarray | None  # (None if built with a_slabs=False)
    b3_val: np.ndarray | None  # (gk, tk, max_b*tn) stacked B slabs
    b3_occ: np.ndarray
    seg: np.ndarray      # (gk*max_a*max_b,) int32; padding -> nt_c
    dtype: np.dtype = np.float32
    prep_ms: float = 0.0       # slab layout build
    symbolic_ms: float = 0.0   # pair expansion + C-tile dictionary

    def padding_ratio(self) -> float:
        """Padded pair slots / real pairs (1.0 = no waste)."""
        return (self.gk * self.max_a * self.max_b) / max(1, self.num_pairs)

    @classmethod
    def from_numpy(cls, fields: dict) -> "GustavsonPlan":
        """Port plan from the JAX package's GustavsonPlan fields given as
        NumPy arrays (e.g. dataclasses.asdict of a spgemm_tpu plan)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in fields.items() if k in names})

    def to_device(self, device) -> tuple[torch.Tensor, ...]:
        """(a3_val, a3_occ, b3_val, b3_occ, seg) on `device`, in the
        argument order of gustavson_numeric."""
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                     for x in (self.a3_val, self.a3_occ, self.b3_val,
                               self.b3_occ, self.seg))

    def numeric_kwargs(self) -> dict:
        return dict(gk=self.gk, max_a=self.max_a, max_b=self.max_b,
                    tm=self.tm, tn=self.tn, nt_c=self.nt_c)


def build_gustavson_plan(a: TileMat, b: TileMat, dtype=np.float32,
                         a_slabs: bool = True,
                         values: bool = True) -> GustavsonPlan:
    """Build the k-group slab plan. With a_slabs=False the stacked A slabs
    are skipped; with values=False only the occupancy slabs are packed
    (the Ozaki slab engine brings its own int8 slice planes, and casting
    wide-exponent f64 values to f32 would overflow for nothing)."""
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if a.tn != b.tm:
        raise ValueError(
            f"inner tile dims must match: A is {a.tm}x{a.tn}, B is {b.tm}x{b.tn}")
    gk = a.gn
    tm, tk, tn = a.tm, a.tn, b.tn
    c_gn = b.gn

    t: dict[str, float] = {}
    with span("prep", t):
        acsc_ptr, acsc_perm = a.csc_view()
        bptr = b.tptr.astype(np.int64)
        cnt_a = np.diff(acsc_ptr).astype(np.int64)
        cnt_b = np.diff(bptr)
        max_a = max(1, int(cnt_a.max()) if a.nt else 1)
        max_b = max(1, int(cnt_b.max()) if b.nt else 1)

        a3_val = a3_occ = b3_val = None
        if a_slabs:
            # A slot of the r-th tile of column k (csc order): k*max_a + rank
            rank_a = np.arange(a.nt, dtype=np.int64) - np.repeat(
                acsc_ptr[:-1].astype(np.int64), cnt_a)
            slot_a = np.repeat(np.arange(gk, dtype=np.int64), cnt_a) * max_a \
                + rank_a
            a3_occ = np.zeros((gk * max_a, tm, tk), dtype=dtype)
            a3_occ[slot_a] = a.occ()[acsc_perm]
            a3_occ = a3_occ.reshape(gk, max_a * tm, tk)
            if values:
                a3_val = np.zeros((gk * max_a, tm, tk), dtype=dtype)
                a3_val[slot_a] = a.dense(dtype)[acsc_perm]
                a3_val = a3_val.reshape(gk, max_a * tm, tk)

        rank_b = np.arange(b.nt, dtype=np.int64) - np.repeat(bptr[:-1], cnt_b)
        slot_b = (np.repeat(np.arange(gk, dtype=np.int64), cnt_b) * max_b
                  + rank_b)

        def hstack(tiles):  # (nt_b, tk, tn) -> (gk, tk, max_b*tn)
            out = np.zeros((gk * max_b, tk, tn), dtype=dtype)
            out[slot_b] = tiles
            return out.reshape(gk, max_b, tk, tn).transpose(
                0, 2, 1, 3).reshape(gk, tk, max_b * tn)

        b3_occ = hstack(b.occ())
        if values:
            b3_val = hstack(b.dense(dtype))

    # pair expansion + C tile dictionary (the symbolic step)
    with span("symbolic", t):
        pairs_per_k = cnt_a * cnt_b
        total = int(pairs_per_k.sum())
        plan = GustavsonPlan(
            gk=gk, max_a=max_a, max_b=max_b, tm=tm, tk=tk, tn=tn, nt_c=0,
            ctrow=np.zeros(0, INDEX_DTYPE), ctcol=np.zeros(0, INDEX_DTYPE),
            num_pairs=total, a3_val=a3_val, a3_occ=a3_occ, b3_val=b3_val,
            b3_occ=b3_occ, seg=np.zeros(gk * max_a * max_b, INDEX_DTYPE),
            dtype=np.dtype(dtype), prep_ms=t["prep_ms"])
        if total == 0:
            return plan
        kk = np.repeat(np.arange(gk, dtype=np.int64), pairs_per_k)
        off = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(pairs_per_k) - pairs_per_k, pairs_per_k)
        x = off // cnt_b[kk]
        y = off % cnt_b[kk]
        ia = acsc_perm[acsc_ptr[kk] + x]
        ib = bptr[kk] + y
        ckey = a.trow[ia].astype(np.int64) * c_gn + b.tcol[ib]
        ukey = np.unique(ckey)
        plan.nt_c = ukey.size
        plan.seg = np.full(gk * max_a * max_b, plan.nt_c, dtype=INDEX_DTYPE)
        plan.seg[(kk * max_a + x) * max_b + y] = np.searchsorted(ukey, ckey)
        plan.ctrow = (ukey // c_gn).astype(INDEX_DTYPE)
        plan.ctcol = (ukey % c_gn).astype(INDEX_DTYPE)
    plan.symbolic_ms = t["symbolic_ms"]
    return plan


def to_pairs(p: torch.Tensor, gk: int, max_a: int, max_b: int, tm: int,
             tn: int) -> torch.Tensor:
    """(gk, max_a*tm, max_b*tn) slab products -> a (gk, max_a, max_b, tm,
    tn) view: pair (k, x, y) is A tile x times B tile y of group k."""
    return p.view(gk, max_a, tm, max_b, tn).permute(0, 1, 3, 2, 4)


def gustavson_core(a3_val, a3_occ, b3_val, b3_occ, seg, *, gk: int,
                   max_a: int, max_b: int, tm: int, tn: int, nt_c: int,
                   acc_dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The slab step as torch ops: one `bmm` (gk, max_a*tm, tk) x (gk, tk,
    max_b*tn) for the values and one for the counts, each permuted to
    pair order straight into one (2*P, tm, tn) buffer (counts at segment
    seg + nt_c + 1), then one `index_add_` into (2*(nt_c+1), tm, tn).
    Products run in full FP32 (full_fp32) or the operands' wider dtype."""
    acc = acc_dtype or a3_val.dtype
    mm = product_dtype(a3_val.dtype, acc)
    n_slots = gk * max_a * max_b
    dev = a3_val.device
    pairs = torch.empty(2 * n_slots, tm, tn, dtype=acc, device=dev)
    with full_fp32():
        for half, (x, y) in enumerate(((a3_val, b3_val), (a3_occ, b3_occ))):
            prod = torch.bmm(x.to(mm), y.to(mm))
            pairs[half * n_slots:(half + 1) * n_slots].view(
                gk, max_a, max_b, tm, tn).copy_(
                    to_pairs(prod, gk, max_a, max_b, tm, tn))
            del prod
    stride = nt_c + 1
    seg = seg.long()
    c = torch.zeros(2 * stride, tm, tn, dtype=acc, device=dev)
    c.index_add_(0, torch.cat([seg, seg + stride]), pairs)
    return c[:nt_c], c[stride:stride + nt_c]


# the JAX package's jitted entry point and its traceable core are one
# function here
gustavson_numeric = gustavson_core


class WindowInfeasible(ValueError):
    """build_strip_args(window=True) found no windowed plan: some block's
    B k-span is too wide (an arrow pattern)."""


@dataclasses.dataclass
class StripArgs:
    """Self-contained plan and host operands for the strip kernel.

    B slabs and A packing are one-time format prep (prep_ms); the symbolic
    phase (C tile dictionary + per-pair slot table, native C++ with a
    NumPy fallback) is the per-run cost (symbolic_ms)."""

    a_val: np.ndarray      # (ntA+max_ablock, tm, tk) float32
    a_occ: np.ndarray      # (ntA+max_ablock, tm, tk) uint16 bfloat16 bits
    b_val: np.ndarray      # (gk_pad, tk, max_b*tn) float32
    b_occ: np.ndarray      # (gk_pad, tk, max_b*tn) uint16 bfloat16 bits
    aptr: np.ndarray       # (gm+1,) A tile-row pointer
    ak: np.ndarray         # (ntA+max_ablock,) tile-col k of each A tile
    slots: np.ndarray      # ((ntA+max_ablock)*max_b,) block-local C slot
    gather_idx: np.ndarray  # (nt_c,) candidate order -> block-padded pos
    ctrow: np.ndarray      # (nt_c,) C tile coordinates, sorted
    ctcol: np.ndarray
    nt_c: int
    num_pairs: int
    gm: int
    gn_c: int
    tm: int
    tk: int
    tn: int
    max_b: int
    max_ablock: int        # max A tiles in any block of block_rows rows
    max_cblock: int        # max C tiles in any block of block_rows rows
    block_rows: int
    kwin: int | None = None   # windowed plan: B k-span per block
    prep_ms: float = 0.0
    symbolic_ms: float = 0.0

    @classmethod
    def from_numpy(cls, fields: dict) -> "StripArgs":
        """Port plan from the JAX package's StripArgs fields given as
        NumPy arrays (e.g. dataclasses.asdict of a spgemm_tpu plan).
        bfloat16 arrays become uint16 views of the same bits; the TPU
        kernels' `kmin`/`meta` and the dtype tag are dropped. No JAX or
        ml_dtypes import."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in fields.items():
            if k not in names:
                continue
            if isinstance(v, np.ndarray) and v.dtype.name == "bfloat16":
                v = v.view(np.uint16)
            kw[k] = v
        return cls(**kw)

    def kernel_kwargs(self) -> dict:
        return dict(gm=self.gm, max_b=self.max_b, max_cblock=self.max_cblock,
                    block_rows=self.block_rows)

    def to_device(self, device) -> tuple[torch.Tensor, ...]:
        """(a_val, a_occ, b_val, b_occ, aptr, ak, slots) on `device`, in
        the argument order of ops/kernels.py:strip_numeric."""
        host = (torch.from_numpy(np.ascontiguousarray(self.a_val)),
                _u16_to_bf16(self.a_occ),
                torch.from_numpy(np.ascontiguousarray(self.b_val)),
                _u16_to_bf16(self.b_occ),
                torch.from_numpy(np.ascontiguousarray(self.aptr, np.int32)),
                torch.from_numpy(np.ascontiguousarray(self.ak, np.int32)),
                torch.from_numpy(np.ascontiguousarray(self.slots, np.int32)))
        return tuple(t.to(device) for t in host)

    def traffic_bytes(self) -> dict:
        """The JAX package's modelled HBM traffic of one numeric dispatch
        + compaction (`spgemm_tpu/ops/gustavson.py:308`, the TPU kernel's
        DMA volume, kept so both packages' headlines divide by the same
        bytes): A tiles streamed once per block; B slabs per the delivery
        mode (windowed: the full window each block; cached: one fetch per
        distinct k per block); block-padded C written once (values +
        counts) then re-read and compacted to nt_c tiles. It does not
        describe the Hopper kernel, which stages A and B per padded C
        slot."""
        occ = self.a_occ.dtype.itemsize
        both = self.a_val.dtype.itemsize + occ
        a_bytes = self.a_val.shape[0] * self.tm * self.tk * both
        slab = self.tk * self.max_b * self.tn * both
        n_blocks = max(1, -(-self.gm // self.block_rows))
        if self.kwin is not None:
            b_bytes = n_blocks * self.kwin * slab
        else:
            aptr = self.aptr.astype(np.int64)
            starts = np.minimum(
                np.arange(0, self.gm + 1, self.block_rows), self.gm)
            if starts[-1] != self.gm:
                starts = np.append(starts, self.gm)
            uniq = 0
            for lo, hi in zip(aptr[starts[:-1]], aptr[starts[1:]]):
                uniq += np.unique(self.ak[lo:hi]).size
            b_bytes = int(uniq) * slab
        padded = n_blocks * self.max_cblock * self.tm * self.tn
        c_bytes = padded * 8          # val + cnt f32 written once
        compact = padded * 8 + self.nt_c * self.tm * self.tn * 4
        return dict(a=a_bytes, b=b_bytes, c=c_bytes, compact=compact,
                    total=a_bytes + b_bytes + c_bytes + compact)


def check_strip_feasible(args: StripArgs, device: torch.device) -> None:
    """Raise if the CUDA kernel cannot take this plan (no-op on the CPU,
    whose plain version takes any plan)."""
    if device.type != "cuda":
        return
    if not kernels.strip_kernel_takes(args.tm, args.tk, args.tn):
        raise ValueError(
            f"strip kernel takes tm % 8 == 0, tn % 128 == 0 and tk a "
            f"multiple of {kernels.TK_MULTIPLE} (the reference's tm%8, "
            f"tk%128, tn%128 with tk relaxed); got {args.tm}x{args.tk} @ "
            f"{args.tk}x{args.tn}")
    n_blocks = max(1, -(-args.gm // args.block_rows))
    if n_blocks * args.max_cblock >= 2 ** 31 \
            or args.max_ablock * args.max_b >= 2 ** 31:
        raise ValueError("strip plan exceeds the kernel's int32 grid and "
                         "slot-scan ranges")


def _numpy_strip_symbolic(a, b, block_rows, max_b, max_ablock,
                          max_cblock_min=1):
    """NumPy fallback for the native symbolic phase. Returns the same
    tuple as utils.native.gustavson_symbolic_native."""
    gk, c_gn = a.gn, b.gn
    acsc_ptr, acsc_perm = a.csc_view()
    bptr = b.tptr.astype(np.int64)
    cnt_a = np.diff(acsc_ptr).astype(np.int64)
    cnt_b = np.diff(bptr)

    pairs_per_k = cnt_a * cnt_b
    total = int(pairs_per_k.sum())
    if total == 0:
        c_tptr = np.zeros(a.gm + 1, dtype=np.int32)
        return (c_tptr, np.zeros(0, INDEX_DTYPE), np.zeros(0, INDEX_DTYPE),
                np.full((a.nt + max_ablock) * max_b, 1, dtype=INDEX_DTYPE),
                np.zeros(0, np.int64), 1, 0)
    kk = np.repeat(np.arange(gk, dtype=np.int64), pairs_per_k)
    off = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(pairs_per_k) - pairs_per_k, pairs_per_k)
    x = off // cnt_b[kk]
    y = off % cnt_b[kk]
    ia = acsc_perm[acsc_ptr[kk] + x]
    ckey = a.trow[ia].astype(np.int64) * c_gn + b.tcol[bptr[kk] + y]
    ukey = np.unique(ckey)
    nt_c = ukey.size
    ctrow = (ukey // c_gn).astype(INDEX_DTYPE)
    ctcol = (ukey % c_gn).astype(INDEX_DTYPE)

    c_tptr = np.zeros(a.gm + 1, dtype=np.int64)
    np.cumsum(np.bincount(ctrow, minlength=a.gm), out=c_tptr[1:])
    block_starts = np.minimum(
        np.append(np.arange(0, a.gm, block_rows), a.gm), a.gm)
    per_block_c = np.diff(c_tptr[block_starts])
    max_cblock = max(max_cblock_min,
                     int(per_block_c.max()) if per_block_c.size else 1)

    # block-local C slot per (A tile, y) pair; padded -> max_cblock
    jpos = np.zeros(gk * max_b, dtype=np.int64)
    rank_b = np.arange(b.nt, dtype=np.int64) - np.repeat(bptr[:-1], cnt_b)
    kb = np.repeat(np.arange(gk, dtype=np.int64), cnt_b)
    jpos[kb * max_b + rank_b] = b.tcol

    slots = np.full((a.nt + max_ablock) * max_b, max_cblock,
                    dtype=INDEX_DTYPE)
    if a.nt:
        ka = a.tcol.astype(np.int64)[:, None]
        ys = np.arange(max_b, dtype=np.int64)[None, :]
        valid = ys < cnt_b[ka]
        j = jpos[ka * max_b + ys]
        rows = a.trow.astype(np.int64)[:, None]
        g = np.searchsorted(ukey, rows * c_gn + j)
        blk_of_row = rows // block_rows
        s = g - c_tptr[np.minimum(blk_of_row * block_rows, a.gm)]
        s[~valid] = max_cblock
        slots[: a.nt * max_b] = s.reshape(-1)

    cblk = ctrow.astype(np.int64) // block_rows
    gather_idx = (cblk * max_cblock + np.arange(nt_c, dtype=np.int64)
                  - c_tptr[np.minimum(cblk * block_rows, a.gm)])
    return c_tptr, ctrow, ctcol, slots, gather_idx, max_cblock, nt_c


def block_k_stats(a: TileMat, block_rows: int):
    """(first k per block, max contiguous k-span) over blocks of
    tile-rows; the span drives the windowed-B plan decision."""
    nb_blocks = max(1, -(-a.gm // block_rows))
    row_starts = np.arange(0, a.gm, block_rows)
    aptr64 = a.tptr.astype(np.int64)
    if a.nt and row_starts.size:
        ak64 = a.tcol.astype(np.int64)
        row_has = np.diff(aptr64) > 0
        firstk = np.where(row_has, ak64[np.minimum(aptr64[:-1], a.nt - 1)],
                          a.gn)
        lastk = np.where(row_has, ak64[np.maximum(aptr64[1:] - 1, 0)], -1)
        blk_min = np.minimum.reduceat(firstk, row_starts)
        blk_max = np.maximum.reduceat(lastk, row_starts)
        bad = blk_max < blk_min
        blk_min[bad] = 0
        blk_max[bad] = 0
        span = max(1, int((blk_max - blk_min + 1).max()))
    else:
        blk_min = np.zeros(nb_blocks, np.int64)
        span = 1
    return blk_min, span


def run_strip_symbolic(a: TileMat, b: TileMat, block_rows: int, max_b: int,
                       max_ablock: int, max_cblock_min: int = 1):
    """The per-run symbolic phase alone (native C++ with NumPy fallback):
    C tile dictionary + per-pair slot table + gather map. `max_cblock_min`
    forces a larger block-padded C geometry (the multi-device plans unify
    it across shards)."""
    from spgemm_tpu_torch.utils.native import gustavson_symbolic_native

    sym = gustavson_symbolic_native(a, b, block_rows, max_b,
                                    a.nt + max_ablock,
                                    max_cblock_min=max_cblock_min)
    if sym is None:
        sym = _numpy_strip_symbolic(a, b, block_rows, max_b, max_ablock,
                                    max_cblock_min=max_cblock_min)
    return sym


def _pack_a(a: TileMat, max_ablock: int):
    """(a_val, a_occ): A's dense tiles and their bfloat16 0/1 bits, padded
    by max_ablock zero tiles; native packing, else NumPy."""
    from spgemm_tpu_torch.utils.native import pack_a_tiles_native

    packed = pack_a_tiles_native(a, max_ablock)
    if packed is not None:
        return packed
    a_val = np.zeros((a.nt + max_ablock, a.tm, a.tn), dtype=np.float32)
    a_val[: a.nt] = a.dense(np.float32)
    a_occ = np.zeros((a.nt + max_ablock, a.tm, a.tn), dtype=np.uint16)
    a_occ[: a.nt] = a.occ() * BF16_ONE
    return a_val, a_occ


def _pack_operands(a: TileMat, b: TileMat, max_ablock: int, max_b: int):
    """(a_val, a_occ, b_val, b_occ): native packing, else NumPy."""
    from spgemm_tpu_torch.utils.native import pack_strip_operands_native

    packed = pack_strip_operands_native(a, b, max_ablock, max_b)
    if packed is not None:
        return packed
    tk, tn, gk = a.tn, b.tn, a.gn
    a_val, a_occ = _pack_a(a, max_ablock)
    bptr = b.tptr.astype(np.int64)
    cnt_b = np.diff(bptr)
    rank_b = np.arange(b.nt, dtype=np.int64) - np.repeat(bptr[:-1], cnt_b)
    kb = np.repeat(np.arange(gk, dtype=np.int64), cnt_b)
    slot_b = kb * max_b + rank_b
    b_val = np.zeros((gk * max_b, tk, tn), dtype=np.float32)
    b_occ = np.zeros((gk * max_b, tk, tn), dtype=np.uint16)
    b_val[slot_b] = b.dense(np.float32)
    b_occ[slot_b] = b.occ() * BF16_ONE
    b_val = b_val.reshape(gk, max_b, tk, tn).transpose(0, 2, 1, 3).reshape(
        gk, tk, max_b * tn)
    b_occ = b_occ.reshape(gk, max_b, tk, tn).transpose(0, 2, 1, 3).reshape(
        gk, tk, max_b * tn)
    return a_val, a_occ, b_val, b_occ


def build_strip_args(a: TileMat, b: TileMat, block_rows: int = 32,
                     window: bool | None = None,
                     b_packed: tuple | None = None,
                     min_geometry: dict | None = None) -> StripArgs:
    """Build the complete strip plan: one-time format prep (A packing +
    stacked B slabs) and the per-run symbolic phase.

    `window` picks the plan shape: None = windowed when every block's B
    k-span is contiguous enough (the JAX plan's refetch rule, so both
    packages pick the same shape), True = windowed or raise, False =
    never windowed.

    `b_packed` supplies pre-packed (b_val, b_occ) slabs, so the
    multi-device plans (parallel/dist.py) pack B once for every shard, and
    `min_geometry` forces lower bounds on {"max_ablock", "max_cblock",
    "kwin"}, so the shards' plans share one geometry."""
    mg = min_geometry or {}
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if a.tn != b.tm:
        raise ValueError(
            f"inner tile dims must match: A is {a.tm}x{a.tn}, B is {b.tm}x{b.tn}")
    tm, tk, tn = a.tm, a.tn, b.tn
    gk = a.gn

    t: dict[str, float] = {}
    with span("prep", t):
        aptr64 = a.tptr.astype(np.int64)
        block_starts = np.minimum(
            np.append(np.arange(0, a.gm, block_rows), a.gm), a.gm)
        per_block = np.diff(aptr64[block_starts])
        max_ablock = max(mg.get("max_ablock", 1),
                         int(per_block.max()) if per_block.size else 1)
        ak = np.zeros(a.nt + max_ablock, dtype=INDEX_DTYPE)
        ak[: a.nt] = a.tcol
        cnt_b = np.diff(b.tptr.astype(np.int64))
        max_b = max(1, int(cnt_b.max()) if b.nt else 1)
        if b_packed is not None:
            a_val, a_occ = _pack_a(a, max_ablock)
            b_val, b_occ = b_packed
        else:
            a_val, a_occ, b_val, b_occ = _pack_operands(a, b, max_ablock,
                                                        max_b)

    with span("symbolic", t):
        c_tptr, ctrow, ctcol, slots, gather_idx, max_cblock, nt_c = \
            run_strip_symbolic(a, b, block_rows, max_b, max_ablock,
                               max_cblock_min=mg.get("max_cblock", 1))
        num_pairs = int(cnt_b[a.tcol].sum()) if a.nt else 0

    kwin = None
    if window is None or window:
        _, kspan = block_k_stats(a, block_rows)
        nb_blocks = max(1, -(-a.gm // block_rows))
        # windows of adjacent blocks overlap; cap the refetch overhead
        if nb_blocks * kspan <= 2 * gk + 16:
            kwin = max(kspan, mg.get("kwin", 1))
            if b_val.shape[0] < kwin:  # B padded to the window, as the JAX plan
                pad = ((0, kwin - b_val.shape[0]), (0, 0), (0, 0))
                b_val = np.pad(b_val, pad)
                b_occ = np.pad(b_occ, pad)
        elif window:
            raise WindowInfeasible(
                f"windowed strip plan infeasible: {nb_blocks} blocks x k span "
                f"{kspan} exceeds 2*gk+16 = {2 * gk + 16} slab fetches")

    return StripArgs(
        a_val=a_val, a_occ=a_occ, b_val=b_val, b_occ=b_occ,
        aptr=a.tptr.astype(INDEX_DTYPE), ak=ak,
        slots=slots, gather_idx=gather_idx,
        ctrow=np.asarray(ctrow, dtype=INDEX_DTYPE),
        ctcol=np.asarray(ctcol, dtype=INDEX_DTYPE),
        nt_c=nt_c, num_pairs=num_pairs,
        gm=a.gm, gn_c=b.gn, tm=tm, tk=tk, tn=tn, max_b=max_b,
        max_ablock=max_ablock, max_cblock=max_cblock,
        block_rows=block_rows, kwin=kwin,
        prep_ms=t["prep_ms"], symbolic_ms=t["symbolic_ms"],
    )


def strip_compact(c_val: torch.Tensor, c_cnt: torch.Tensor,
                  gidx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Device-side compaction (port of `strip_compact_device`): gather the
    real candidate tiles out of the block-padded layout and pack the
    structural counts into occupancy words. Returns (values (nt_c, tm, tn)
    f32, words (nt_c, tm, tn/32) int32); bit c%32 of word c//32 is set
    when column c is occupied, LSB first, as the JAX package packs them."""
    v = c_val.index_select(0, gidx)
    cnt = c_cnt.index_select(0, gidx)
    nt, tm, tn = v.shape
    if tn % 32:
        raise ValueError(f"occupancy packing needs tn % 32 == 0, got {tn}")
    bits = (cnt > 0).reshape(nt, tm, tn // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=v.device)
    w = (bits << shifts).sum(dim=3)  # in [0, 2^32)
    # bit 31 is int32's sign bit: map [2^31, 2^32) onto the negative words
    words = torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)
    return v, words


def unpack_occ_words(words: np.ndarray, tn: int) -> np.ndarray:
    """Host: expand packed occupancy words back to a (nt, tm, tn) bool
    array (the words are LSB-first int32, little-endian bytes)."""
    by = np.ascontiguousarray(words).view(np.uint8)
    bits = np.unpackbits(by, axis=-1, bitorder="little")
    # explicit last dim: an empty C (0 tiles) must reshape too
    return bits.reshape(words.shape[0], words.shape[1], words.shape[2] * 32)[
        :, :, :tn].astype(bool)


@dataclasses.dataclass
class PickedTiles:
    """C's entries picked out of candidate-order tile planes (pick_tiles)
    and downloaded: the candidate tiles that hold an entry, and the
    TileMat arrays of those tiles."""

    tm: int
    tn: int
    keep: np.ndarray    # (nt_c,) bool: the candidate tile holds an entry
    rc: np.ndarray      # (nnz,) int32 r*tn + c
    val: torch.Tensor   # (nnz,) host tensor in the planes' dtype
    mask: np.ndarray    # (nt, tm, ceil(tn/32)) uint32, LSB first
    rowptr: np.ndarray  # (nt, tm+1) int32

    def tilemat(self, ctrow, ctcol, shape: tuple[int, int]) -> TileMat:
        """The TileMat of C (values widened to f64), the candidate tiles
        at (ctrow, ctcol): array for array what _compact_to_tilemat
        builds from the same planes."""
        trow = np.asarray(ctrow)[self.keep].astype(INDEX_DTYPE)
        tcol = np.asarray(ctcol)[self.keep].astype(INDEX_DTYPE)
        gm = cdiv(shape[0], self.tm)
        tptr = np.zeros(gm + 1, dtype=INDEX_DTYPE)
        np.cumsum(np.bincount(trow, minlength=gm), out=tptr[1:])
        tnnz_ptr = np.zeros(trow.size + 1, dtype=INDEX_DTYPE)
        np.cumsum(self.rowptr[:, self.tm], out=tnnz_ptr[1:])
        return TileMat(shape=shape, tm=self.tm, tn=self.tn, trow=trow,
                       tcol=tcol, tptr=tptr, tnnz_ptr=tnnz_ptr, rc=self.rc,
                       val=self.val.to(torch.float64).numpy(),
                       mask=self.mask, rowptr=self.rowptr)


def pick_tiles(c_val: torch.Tensor, c_occ: torch.Tensor,
               into: dict | None = None,
               moved: dict | None = None) -> PickedTiles:
    """Pick C's entries out of candidate-order tile planes where the
    planes are (torch ops, the same on the card and the CPU), then
    download C's arrays alone: the keep flags, rc, the values in the
    planes' dtype, and the kept tiles' mask words and row pointers.

    c_val is (nt_c, tm, tn). c_occ is either strip_compact's int32
    occupancy words (nt_c, tm, tn/32), or counts or bools (nt_c, tm, tn)
    read as > 0, so a structural zero (value 0, count > 0) stays an
    entry. Candidate tiles with no entry are pruned; the entries keep the
    candidate order, row-major inside a tile, as _compact_to_tilemat
    does. `into` (a timings dict) gets download_ms, the copies alone;
    `moved` their d2h_bytes. `pick_tiles.device_calls` counts calls on
    CUDA planes, `pick_tiles.host_calls` on CPU planes."""
    nt_c, tm, tn = c_val.shape
    mw = cdiv(tn, MASK_BITS)
    dev = c_val.device
    if c_val.is_cuda:
        pick_tiles.device_calls += 1
    else:
        pick_tiles.host_calls += 1
    # bytes of the words, LSB first: bit k of byte j is column 8j + k
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                           device=dev)
    if c_occ.dtype == torch.int32:
        words = c_occ
        by = words.view(torch.uint8).reshape(nt_c, tm, mw * 4, 1)
        bits = (by & weights) != 0
        occ = bits.reshape(nt_c, tm, mw * MASK_BITS)[:, :, :tn]
    else:
        occ = c_occ > 0
        if tn % MASK_BITS:
            padded = torch.zeros(nt_c, tm, mw * MASK_BITS,
                                 dtype=torch.bool, device=dev)
            padded[:, :, :tn] = occ
        else:
            padded = occ
        by = padded.view(torch.uint8).reshape(nt_c, tm, mw * 4, 8)
        words = (by * weights).sum(dim=3, dtype=torch.uint8).view(
            torch.int32)
    rowptr = torch.zeros(nt_c, tm + 1, dtype=torch.int32, device=dev)
    rowptr[:, 1:] = occ.sum(dim=2).cumsum(dim=1)
    keep = rowptr[:, tm] > 0
    kept = torch.nonzero(keep).squeeze(1)
    # int64: nt_c*tm*tn may pass 2^31
    flat = torch.nonzero(occ.reshape(-1)).squeeze(1)
    rc = (flat % (tm * tn)).to(torch.int32)
    val = c_val.reshape(-1).index_select(0, flat)
    out = (keep, rc, val, words.index_select(0, kept),
           rowptr.index_select(0, kept))
    if c_val.is_cuda:  # the copies alone inside download_ms
        torch.cuda.synchronize(dev)
    count_bytes(moved, "d2h_bytes", *out)
    with span("download", into):
        keep, rc, val, mask, rowptr = (t.cpu() for t in out)
    return PickedTiles(tm=tm, tn=tn, keep=keep.numpy(), rc=rc.numpy(),
                       val=val, mask=mask.numpy().view(MASK_DTYPE),
                       rowptr=rowptr.numpy())


pick_tiles.device_calls = 0
pick_tiles.host_calls = 0


def download_compact(c_val: torch.Tensor, c_cnt: torch.Tensor,
                     args: StripArgs, into: dict | None = None,
                     moved: dict | None = None) -> PickedTiles:
    """Gather the real candidate tiles out of the block-padded planes,
    pack their occupancy into words (strip_compact) and pick C's entries
    on the device (pick_tiles): only C's arrays are downloaded. tn not a
    multiple of 32 (small test tiles) skips the bit packing. `into` (a
    timings dict) gets download_ms; `moved` the h2d_bytes of the gather
    index and the d2h_bytes of the copies."""
    gidx = torch.from_numpy(args.gather_idx.astype(np.int64)).to(c_val.device)
    count_bytes(moved, "h2d_bytes", gidx)
    if args.tn % 32 == 0:
        v, occ = strip_compact(c_val, c_cnt, gidx)
    else:
        v, occ = c_val.index_select(0, gidx), c_cnt.index_select(0, gidx)
    return pick_tiles(v, occ, into, moved)


def strip_numeric(args: StripArgs, device=None, into: dict | None = None,
                  moved: dict | None = None) -> PickedTiles:
    """Upload the plan's operands, run the strip numeric phase
    (ops/kernels.py:strip_numeric) on `device` (None means CUDA), compact
    and pick C's entries on the device (download_compact). Returns the
    downloaded PickedTiles, in candidate order. `into` (a timings dict)
    gets upload_ms, numeric_ms (kernel, device compaction and picking,
    download) and download_ms; `moved` the call's h2d_bytes and
    d2h_bytes."""
    device = resolve_device(device)
    check_strip_feasible(args, device)
    with span("upload", into):
        ops = args.to_device(device)
    count_bytes(moved, "h2d_bytes", *ops)
    with span("numeric", into):
        c_val, c_cnt = kernels.strip_numeric(*ops, **args.kernel_kwargs())
        del ops  # freed before the compaction, as the device peak was
        return download_compact(c_val, c_cnt, args, into, moved)
