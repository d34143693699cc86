"""SpMV / SpMM on the tiled sparse format, Y = A @ X with dense X (port of
`spgemm_tpu/ops/spmm.py`).

Three routes, with the JAX package's router kept:
  * the strip kernel (`_spmm_strip`): the packed plan through
    ops/spmm_kernels.py:spmm_strip, in the resident or the window form.
    The router decides on the reference's 128-padded k, as the JAX package
    does; X and Y are then packed at 8, 16 or 32 columns for k <= 32
    (the kernel's narrow form), else at that k_pad;
  * the tile fallback (`_spmm_tiles`): gather, `bmm` and `index_add_` per
    chunk of stored tiles; the f64 route on CUDA and the route for tiles the
    kernel does not take;
  * the gather route (`spmm_gather`): straight from CSR, one X row gather
    per nonzero and a multiply-reduce over row-length classes, for
    unstructured patterns whose tiles are mostly padding.

NumPy on the host, torch on the device; `device` None means CUDA and
"cpu" runs the plain versions. Public functions return torch tensors on
the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgemm_tpu_torch.models.csr import INDEX_DTYPE
from spgemm_tpu_torch.models.tile import TileMat
from spgemm_tpu_torch.ops import spmm_kernels
from spgemm_tpu_torch.ops.esc import is_f64
from spgemm_tpu_torch.utils.timing import cuda_event_ms, resolve_device

# "resident" on the card means X is held in the H100's 50 MiB L2 while the
# grid sweeps the tile rows (the TPU held it in 100 MB of VMEM, which does
# not carry). Above that the window form runs: each block of block_rows
# tile rows reads only its X window, which stays in L2 as the sweep moves.
L2_BYTES = 50 << 20


def _spmm_tiles(a_dense: torch.Tensor, trow: torch.Tensor,
                tcol: torch.Tensor, xb: torch.Tensor, *, gm: int,
                chunk: int = 65536) -> torch.Tensor:
    """Y (gm, tm, k): Y[trow[t]] += A_dense[t] @ X_blocks[tcol[t]], a
    `bmm` and an `index_add_` per chunk of stored tiles."""
    nt, tm, _ = a_dense.shape
    y = torch.zeros(gm, tm, xb.shape[2], dtype=a_dense.dtype,
                    device=a_dense.device)
    for lo in range(0, nt, chunk):
        sl = slice(lo, lo + chunk)
        y.index_add_(0, trow[sl].long(),
                     torch.bmm(a_dense[sl], xb[tcol[sl].long()]))
    return y


def _spmm_block_stats(a: TileMat, block_rows: int):
    """(max_ablock, kmin per block, max k-span per block)."""
    aptr64 = a.tptr.astype(np.int64)
    starts = np.minimum(
        np.append(np.arange(0, a.gm, block_rows), a.gm), a.gm)
    per_block = np.diff(aptr64[starts])
    max_ablock = max(1, int(per_block.max()) if per_block.size else 1)
    n_blocks = max(1, -(-a.gm // block_rows))
    row_starts = np.arange(0, a.gm, block_rows)
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
        blk_min = np.zeros(n_blocks, np.int64)
        span = 1
    return max_ablock, blk_min, span


def _spmm_mode(a: TileMat, k_pad: int, block_rows: int = 64, *,
               device: torch.device):
    """Returns (mode, stats): 'resident', 'window' or 'xla' (the tile
    fallback), and stats = (max_ablock, kmin per block, max k-span),
    computed once and threaded to the packing and kernel stages.

    On the CPU the plain version takes any plan: 'resident', as the JAX
    package answers off the TPU. On CUDA: 'xla' where the kernel is not
    instantiated for the tile height (any tk is taken); 'resident' while X
    (gn*tn*k_pad f32) fits the L2; 'window' above that."""
    stats = _spmm_block_stats(a, block_rows)
    if device.type == "cpu":
        return "resident", stats
    if a.tm not in spmm_kernels.SPMM_TM:
        return "xla", stats
    if a.gn * a.tn * k_pad * 4 <= L2_BYTES:
        return "resident", stats
    return "window", stats


def spmm(a: TileMat, x, *, dtype=torch.float32, backend: str = "auto",
         device=None) -> torch.Tensor:
    """Y = A @ X on `device` (None means CUDA). x: (n, k) or (n,)
    array-like. Returns (m, k) / (m,) in `dtype` on the device.

    backend "auto" keeps the JAX package's router: the raw-CSR gather route
    (spmm_gather) when its modelled traffic undercuts the tile kernel's
    (with a 16 MB floor that keeps small problems on the kernel), else the
    strip kernel in the mode _spmm_mode picks, else the tile fallback.
    "gather" forces the gather route, "xla" the tile fallback, and
    "strip" the kernel, raising ValueError when no kernel mode applies.
    float64 runs the tile fallback (the kernel is f32) except on the CPU,
    where the plain strip version runs it."""
    if backend not in ("auto", "strip", "xla", "gather"):
        raise ValueError(f"unknown backend {backend!r}")
    x = np.asarray(x)
    vec = x.ndim == 1
    if vec:
        x = x[:, None]
    if x.shape[0] != a.n:
        raise ValueError(f"shape mismatch: A is {a.shape}, X is {x.shape}")
    k = x.shape[1]
    k_pad = max(128, -(-k // 128) * 128)
    dev = resolve_device(device)

    f64 = is_f64(dtype)
    hw_ok = dev.type == "cpu" or not f64  # the kernel is f32
    stats = None
    mode = "xla"
    if hw_ok and backend in ("auto", "strip"):
        mode, stats = _spmm_mode(a, k_pad, device=dev)
    if backend == "strip" and mode == "xla":
        raise ValueError("strip SpMM infeasible: the kernel takes tm in "
                         f"{spmm_kernels.SPMM_TM} and float32 on CUDA")
    # the JAX package's traffic model: the tile kernels stream tm*tn*4 B
    # per stored tile, the gather route one k_pad-wide X row + 8 B of
    # (value, column) per nonzero
    gather_bytes = a.nnz * (k_pad * 4 + 8)
    tile_bytes = a.nt * a.tm * a.tn * 4
    if backend == "gather" or (
        backend == "auto"
        and ((mode == "xla" and tile_bytes > 1 << 30)
             or (not f64 and gather_bytes < tile_bytes
                 and tile_bytes > 16 << 20))
    ):
        return _finish(spmm_gather(a.to_csr(), x, dtype=dtype, device=dev),
                       vec, a, k)
    if mode in ("resident", "window"):
        y = _spmm_strip(a, x, k_pad, dtype, mode=mode, stats=stats,
                        device=dev)
    else:
        np_dt = np.float64 if f64 else np.float32
        pad = a.gn * a.tn - a.n
        xb = np.pad(x, ((0, pad), (0, 0))).reshape(a.gn, a.tn, k)
        up = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        y = _spmm_tiles(up(a.dense(np_dt)), up(a.trow), up(a.tcol),
                        up(xb.astype(np_dt)), gm=a.gm).reshape(a.gm * a.tm, k)
    return _finish(y, vec, a, k)


def _finish(y, vec, a, k):
    y = y[: a.m, :k]
    return y[:, 0] if vec else y


def spmv(a: TileMat, x, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """y = A @ x for a 1-D x (SpMV), via the SpMM path."""
    return spmm(a, x, dtype=dtype, device=device)


def _spmm_gather_classes(a, cap: int = 512, gran: int = 4):
    """Row-length classes for the gather SpMM: rows binned by nnz at
    `gran` granularity (padding <= gran-1 gathered X rows per row); rows
    longer than `cap` split into sibling segments summed on the device.
    Returns [(c, [(row, data offset, length), ...])] sorted by c."""
    row_nnz = np.diff(a.indptr).astype(np.int64)
    by_c: dict[int, list] = {}
    for r in np.flatnonzero(row_nnz > 0):
        ln = int(row_nnz[r])
        lo = int(a.indptr[r])
        while ln > 0:
            seg = min(ln, cap)
            c = max(gran, -(-seg // gran) * gran)
            by_c.setdefault(c, []).append((r, lo, seg))
            lo += seg
            ln -= seg
    return sorted(by_c.items())


def _pack_spmm_gather(a_csr, x, np_dt, cap: int = 512, gran: int = 4):
    """Operand packing for the gather SpMM and its timer: the padded X
    block (a zero row at index n for padding lanes) plus per-class (av,
    col) planes and the segment row map."""
    x = np.asarray(x)
    k = x.shape[1]
    k_pad = max(128, -(-k // 128) * 128)
    xb = np.zeros((a_csr.n + 1, k_pad), np_dt)
    xb[: a_csr.n, :k] = x
    classes = []
    for c, segs in _spmm_gather_classes(a_csr, cap, gran):
        sN = len(segs)
        av = np.zeros((sN, c), np_dt)
        col = np.full((sN, c), a_csr.n, np.int32)  # pad: zero X row
        rows = np.zeros(sN, np.int64)
        for si, (r, lo, seg) in enumerate(segs):
            av[si, :seg] = a_csr.data[lo : lo + seg]
            col[si, :seg] = a_csr.indices[lo : lo + seg]
            rows[si] = r
        classes.append((av, col, rows))
    return xb, classes, k, k_pad


def _spmm_gather_kernel(av: torch.Tensor, col: torch.Tensor,
                        xb: torch.Tensor) -> torch.Tensor:
    """out[s, :] = sum_c av[s, c] * X[col[s, c]]: an `index_select` of X
    rows and a multiply-reduce (the fused form of the JAX package's
    kernel)."""
    s_n, c = av.shape
    xg = xb.index_select(0, col.reshape(-1)).view(s_n, c, xb.shape[1])
    return (av[:, :, None] * xg).sum(dim=1)


def _gather_operands(a_csr, x, np_dt, dev):
    xb, classes, k, k_pad = _pack_spmm_gather(a_csr, x, np_dt)
    up = lambda v: torch.from_numpy(v).to(dev)
    return up(xb), [tuple(map(up, cls)) for cls in classes], k, k_pad


def _gather_apply(a_csr, xd, dev_classes, k_pad):
    y = torch.zeros(a_csr.m, k_pad, dtype=xd.dtype, device=xd.device)
    for av, col, rows in dev_classes:
        # sibling segments of split rows sum here
        y.index_add_(0, rows, _spmm_gather_kernel(av, col, xd))
    return y


def spmm_gather(a_csr, x, *, dtype=torch.float32, device=None) -> torch.Tensor:
    """Y = A @ X for unstructured A, straight from CSR: no tiles, one X row
    gather per nonzero and a multiply-reduce over row-length classes, in
    `dtype` on `device` (None means CUDA). Returns (m, k)."""
    dev = resolve_device(device)
    np_dt = np.float64 if is_f64(dtype) else np.float32
    xd, dev_classes, k, k_pad = _gather_operands(a_csr, x, np_dt, dev)
    return _gather_apply(a_csr, xd, dev_classes, k_pad)[:, :k]


@dataclasses.dataclass
class SpmmOperands:
    """The strip SpMM kernel's packed host planes (the tuple the JAX
    package's _pack_spmm_operands returns, in its order)."""

    a_dense: np.ndarray   # (nt + max_ablock, tm, tk), zero tail
    xb: np.ndarray        # (gn, tn, width), width from pack_width(k)
    aptr: np.ndarray      # (gm+1,) int32
    ak: np.ndarray        # (nt + max_ablock,) int32 tile column
    arow: np.ndarray      # (nt + max_ablock,) int32 tile row
    max_ablock: int

    def to_device(self, device) -> tuple[torch.Tensor, ...]:
        """(a_dense, xb, aptr, ak, arow) on `device`, contiguous, in the
        argument order of ops/spmm_kernels.py:spmm_strip."""
        return tuple(torch.from_numpy(np.ascontiguousarray(v)).to(device)
                     for v in (self.a_dense, self.xb, self.aptr, self.ak,
                               self.arow))


def _pack_spmm_operands(a: TileMat, x: np.ndarray, k_pad: int, dtype,
                        block_rows: int,
                        max_ablock: int | None = None) -> SpmmOperands:
    """Operand packing for the strip SpMM kernel and its timer, X at
    `k_pad` columns (the JAX package's 128-padded width, or a narrow
    width from spmm_kernels.pack_width)."""
    k = x.shape[1]
    np_dtype = np.float64 if is_f64(dtype) else np.float32
    xb = np.zeros((a.gn, a.tn, k_pad), dtype=np_dtype)
    xb.reshape(a.gn * a.tn, k_pad)[: a.n, :k] = x

    if max_ablock is None:
        max_ablock = _spmm_block_stats(a, block_rows)[0]

    a_dense = np.zeros((a.nt + max_ablock, a.tm, a.tn), dtype=np_dtype)
    a_dense[: a.nt] = a.dense(np_dtype)
    ak = np.zeros(a.nt + max_ablock, dtype=INDEX_DTYPE)
    ak[: a.nt] = a.tcol
    arow = np.zeros(a.nt + max_ablock, dtype=INDEX_DTYPE)
    arow[: a.nt] = a.trow
    aptr = a.tptr.astype(INDEX_DTYPE)
    return SpmmOperands(a_dense, xb, aptr, ak, arow, max_ablock)


def _window_kmin(a: TileMat, stats) -> np.ndarray:
    """Per-block window start; kwin <= gn by construction, so xb (gn
    slabs) always covers the clipped windows."""
    _, blk_min, kwin = stats
    return np.clip(blk_min, 0, a.gn - kwin).astype(INDEX_DTYPE)


def _spmm_strip(a: TileMat, x: np.ndarray, k_pad: int, dtype,
                block_rows: int = 64, mode: str = "resident", stats=None, *,
                device: torch.device) -> torch.Tensor:
    """The strip kernel route. `k_pad` is the reference's 128-padded width,
    which the router decided on; X and Y are packed at
    spmm_kernels.pack_width(k), which is narrower for k <= 32. Returns
    (gm*tm, width)."""
    if stats is None:
        stats = _spmm_block_stats(a, block_rows)
    width = spmm_kernels.pack_width(x.shape[1])
    ops = _pack_spmm_operands(a, x, width, dtype, block_rows,
                              max_ablock=stats[0])
    kmin = None
    if mode == "window":
        kmin = torch.from_numpy(_window_kmin(a, stats)).to(device)
    y = spmm_kernels.spmm_strip(*ops.to_device(device), kmin, gm=a.gm,
                                block_rows=block_rows)
    return y.reshape(-1, width)[: a.gm * a.tm]


def time_spmm(a: TileMat, x, *, warmup: int = 3, iters: int = 20,
              device=None) -> float:
    """Median device ms of one strip SpMM kernel launch (X resident) on
    uploaded operands, by CUDA events. Raises without a card, and when
    the resident mode does not apply (time the window mode via spmm())."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("time_spmm times the CUDA kernel: needs a CUDA "
                           "device")
    x = np.asarray(x)
    k_pad = max(128, -(-x.shape[1] // 128) * 128)
    block_rows = 64
    mode, stats = _spmm_mode(a, k_pad, block_rows, device=dev)
    if mode != "resident":
        raise ValueError("strip SpMM (resident X) infeasible for this "
                         "matrix/k; time the window mode via spmm()")
    ops = _pack_spmm_operands(a, x, spmm_kernels.pack_width(x.shape[1]),
                              torch.float32, block_rows,
                              max_ablock=stats[0]).to_device(dev)
    return cuda_event_ms(
        lambda: spmm_kernels.spmm_strip(*ops, gm=a.gm, block_rows=block_rows),
        warmup=warmup, iters=iters)


def time_spmm_gather(a_csr, x, *, warmup: int = 3, iters: int = 20,
                     device=None) -> float:
    """Median device ms of the gather SpMM's device work (every class's
    gather-multiply-reduce and its index_add_) on uploaded operands, by
    CUDA events. Raises without a card."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("time_spmm_gather needs a CUDA device")
    xd, dev_classes, _, k_pad = _gather_operands(a_csr, x, np.float32, dev)
    return cuda_event_ms(lambda: _gather_apply(a_csr, xd, dev_classes, k_pad),
                         warmup=warmup, iters=iters)
