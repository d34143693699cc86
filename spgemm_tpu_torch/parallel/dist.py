"""Multi-device SpGEMM over torch.distributed (port of
`spgemm_tpu/parallel/dist.py`).

The JAX package runs one SPMD program over a one-axis `jax.sharding.Mesh`
("x") under `shard_map`. Here the same formulations run the PyTorch way:
one process per device, and the mesh axis is the ranks of a
`torch.distributed` process group (`Mesh`, from `make_mesh`). Every rank
builds every shard's host plan (the unified geometries need all of them,
as in the reference) and uploads only its own shard. Each JAX collective
is one torch.distributed call:

  * `lax.all_gather(..., tiled=True)` -> `dist.all_gather_into_tensor` on
    shards padded to equal sizes;
  * `lax.ppermute` in the ring -> `dist.batch_isend_irecv`, one send to
    one neighbour and one receive from the other, B held one shard at a
    time;
  * the assembly of C (the reference's `np.asarray` of the sharded
    outputs, or `multihost_utils.process_allgather` across hosts) -> an
    all-gather of every rank's padded C output, so every rank assembles
    the full C.

Collectives move the tensors' bytes (a uint8 view), so every dtype rides
every backend that carries uint8. The backend is the caller's process
group: NCCL on CUDA (one card per rank), gloo on the CPU. Nothing is
copied to the host to get round a backend, and a strip shard on CUDA
launches the strip kernel (ops/kernels.py:strip_numeric) or raises. With
no process group initialised, `make_mesh()` is a one-rank mesh whose
collectives are the identity.

Partitioning follows the reference: C tile-row i is owned by the rank
that owns A tile-row i (pair-count balanced tile-row slabs), so no
cross-rank reduction is needed; ranks exchange only B (or nothing, on the
ESC route). Products multiply in full FP32 (`full_fp32`), as the
reference multiplies at Precision.HIGHEST; acc_dtype is float32 unless
the caller asks for another (pairs, gustavson, ring).

Formulations: `spgemm_sharded_pairs` (tile pairs), `spgemm_sharded`
(Gustavson slabs, B all-gathered), `spgemm_sharded_strip` (the strip
kernel per shard), `spgemm_sharded_esc` (the ESC scan kernel per row
slab), `spgemm_sharded_ring` (B rotated around the ring) and
`spgemm_sharded_ozaki` (exact f64 through the Ozaki slab engine). Each
takes an optional `timer` (utils/timing.py:StepTimer) that collects host
milliseconds per step: plan, upload, numeric, collective, assemble (the
device is synchronised at each step's end while timing).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import socket
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from spgemm_tpu_torch.models.csr import CSR, INDEX_DTYPE
from spgemm_tpu_torch.models.tile import TileMat, cdiv
from spgemm_tpu_torch.ops import kernels, numeric, scan_kernels
from spgemm_tpu_torch.ops.esc import (SCAN_BLK, _combine_apply,
                                      build_esc_scan_plan, esc_scan_numeric,
                                      esc_scan_trim, esc_scan_trim_combined,
                                      meta16_plane)
from spgemm_tpu_torch.ops.gustavson import (build_gustavson_plan,
                                            build_strip_args,
                                            check_strip_feasible,
                                            gustavson_core, strip_compact,
                                            unpack_occ_words, _u16_to_bf16)
from spgemm_tpu_torch.ops.ozaki import ozaki_core, slice_and_pack
from spgemm_tpu_torch.ops.spgemm import _compact_to_tilemat
from spgemm_tpu_torch.ops.symbolic import PairSchedule, build_pair_schedule
from spgemm_tpu_torch.utils.timing import resolve_device


# --- the mesh -------------------------------------------------------------

@dataclasses.dataclass
class Mesh:
    """The port's one-axis mesh ("x"): the ranks of a torch.distributed
    process group, one device each. `group` is None for the one-rank mesh
    of a process with no process group (collectives are then the
    identity)."""

    group: object
    size: int
    rank: int
    device: torch.device


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """The mesh of the initialised process group (all its ranks), or a
    one-rank mesh when none is initialised. `n_devices`, if given, must
    equal the group's size. `device` None means one card per
    rank: cuda:<LOCAL_RANK or rank>, raising where that card is missing;
    the CPU runs only when asked for by name (with gloo)."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        size, rank = dist.get_world_size(), dist.get_rank()
    else:
        group, size, rank = None, 1, 0
    if n_devices not in (None, size):
        raise ValueError(f"make_mesh({n_devices}): the process group has "
                         f"{size} rank(s); start one process per device")
    if device is None:
        resolve_device(None)  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} needs card {local}, but only "
                f"{torch.cuda.device_count()} are present (one card per "
                "rank)")
        dev = torch.device("cuda", local)
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    return Mesh(group=group, size=size, rank=rank, device=dev)


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> int:
    """Join this process to a process group of `num_processes` ranks
    rendezvousing at `coordinator_address` ("host:port", TCP), after which
    `make_mesh()` spans every rank and drives the same formulations. Each
    rank then builds and uploads only its own shard:

        init_multihost("host0:1234", num_processes=H, process_id=h)
        mesh = make_mesh()
        arrays, plan = place_strip_partition(a, b, mesh)   # this rank
        c = spgemm_sharded_strip(a, b, mesh, placed=(arrays, plan))

    `backend` None is NCCL where a card is present, else gloo. With no
    coordinator and at most one process it does nothing (as the
    reference), and it does nothing when a group is already initialised.
    Returns the process count. Under torchrun, `dist.init_process_group()`
    from its environment does the same."""
    if dist.is_initialized():
        return dist.get_world_size()
    if num_processes in (None, 1) and coordinator_address is None:
        return 1
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_multihost needs coordinator_address, "
                         "num_processes and process_id")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return dist.get_world_size()


def _free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _rank_main(fn, rank: int, n_ranks: int, port: int, backend: str,
               args: tuple, results) -> None:
    try:
        init_multihost(f"127.0.0.1:{port}", num_processes=n_ranks,
                       process_id=rank, backend=backend)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, n_ranks: int, *, backend: str, args: tuple = (),
                timeout: float = 600.0) -> list:
    """Run fn(*args) in `n_ranks` fresh processes (spawn) joined into one
    process group over `backend` on a free local port; returns each rank's
    result in rank order. `fn` must be importable (a module-level
    function). Raises if a rank fails, dies or outlasts `timeout`
    seconds; every process is stopped before it returns."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n_ranks, port, backend, args, results))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < n_ranks:
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n_ranks} ranks outlasted {timeout} s")
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                gone = [(i, p.exitcode) for i, p in enumerate(procs)
                        if p.exitcode is not None and i not in got]
                if not gone:
                    continue
                try:  # a rank puts its result before it exits
                    rank, ok, out = results.get(timeout=5.0)
                except queue.Empty:
                    raise RuntimeError(f"rank(s) exited without a result "
                                       f"(rank, exit code): {gone}") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == n_ranks else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(n_ranks)]


# --- collectives ------------------------------------------------------------

# the tiled all-gather; torch 2.13 renames all_gather_into_tensor
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A uint8 view of a contiguous tensor's bytes (last dim scaled)."""
    return t.contiguous().view(torch.uint8)


def _all_gather(mesh: Mesh, t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """`lax.all_gather(t, "x", axis=axis, tiled=True)`: the ranks' equal
    shards concatenated along `axis`, in rank order, on every rank."""
    if mesh.group is None:
        return t
    src = t.movedim(axis, 0).contiguous()
    out = torch.empty((mesh.size * src.shape[0],) + src.shape[1:],
                      dtype=src.dtype, device=src.device)
    _all_gather_single(_bytes(out), _bytes(src), group=mesh.group)
    return out.movedim(0, axis)


def _gather_outputs(mesh: Mesh, *outs: torch.Tensor) -> list[np.ndarray]:
    """Every rank's padded output, stacked (D, ...) on the host of every
    rank: the all-gather that assembles C everywhere."""
    return [_all_gather(mesh, o.unsqueeze(0)).cpu().numpy() for o in outs]


def _ring_shift(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """`lax.ppermute(t, "x", [((d + 1) % D, d)])`: this rank receives the
    shard of rank + 1 and sends its own to rank - 1."""
    src = t.contiguous()
    out = torch.empty_like(src)
    me, n = mesh.rank, mesh.size
    peer = lambda r: dist.get_global_rank(mesh.group, r % n)
    ops = [dist.P2POp(dist.isend, _bytes(src), peer(me - 1), mesh.group),
           dist.P2POp(dist.irecv, _bytes(out), peer(me + 1), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


@contextlib.contextmanager
def _step(timer, name: str, device: torch.device):
    """timer.step(name) with the device synchronised at its end; nothing
    when not timing."""
    if timer is None:
        yield
        return
    with timer.step(name):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _up(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _pair_balanced_rows(a: TileMat, b: TileMat, ndev: int):
    """(row_start, row_end) per rank: contiguous tile-row ranges with
    about equal (A tile, B tile) pair counts (the reference's policy for
    the slab, ring and Ozaki plans)."""
    k = a.tcol.astype(np.int64)
    bptr = b.tptr.astype(np.int64)
    pair_per_tile = bptr[k + 1] - bptr[k]
    pairs_per_row = np.zeros(a.gm, dtype=np.int64)
    np.add.at(pairs_per_row, a.trow, pair_per_tile)
    cum = np.cumsum(pairs_per_row)
    total = int(cum[-1]) if cum.size else 0
    bounds = np.searchsorted(cum, np.arange(1, ndev) * (total / ndev))
    row_start = (np.concatenate([[0], bounds + 1]) if ndev > 1
                 else np.array([0]))
    row_end = (np.concatenate([bounds + 1, [a.gm]]) if ndev > 1
               else np.array([a.gm]))
    return row_start, row_end


def _keep(stacked: np.ndarray, counts, shape) -> np.ndarray:
    """Each rank's first counts[d] rows of its padded output, in rank
    order (the real C tiles), or an empty (0, *shape) array."""
    if not int(np.sum(counts)):
        return np.zeros((0,) + tuple(shape), stacked.dtype)
    return np.concatenate([stacked[d, : counts[d]]
                           for d in range(len(counts))])


# --- pair formulation -------------------------------------------------------

@dataclasses.dataclass
class DistPlan:
    """Host-side SPMD plan for one (A, B, mesh size) triple."""

    ndev: int
    # per-rank padded arrays, stacked on axis 0 (the mesh axis)
    a_val: np.ndarray    # (D, ntA_max, tm, tk)
    a_occ: np.ndarray
    b_val: np.ndarray    # (D, ntB_max, tk, tn)  (sharded; all-gathered)
    b_occ: np.ndarray
    pa: np.ndarray       # (D, P_max) local A tile index
    pb: np.ndarray       # (D, P_max) index into the all-gathered padded B
    seg: np.ndarray      # (D, P_max) local C segment, padding -> s_max
    s_max: int           # local segments per rank (excl. dummy)
    seg_counts: np.ndarray   # (D,) real segments per rank
    ctrow: np.ndarray        # (ntC,) global candidate C tile coords
    ctcol: np.ndarray
    schedule: PairSchedule


def plan_row_partition(a: TileMat, b: TileMat, ndev: int,
                       dtype=np.float32) -> DistPlan:
    """Partition A tile-rows (and C tile-rows with them) over `ndev`
    ranks, balancing total pair count per rank."""
    sched = build_pair_schedule(a, b)

    pairs_per_seg = np.diff(sched.pair_ptr).astype(np.int64)
    seg_row = sched.ctrow  # sorted ascending
    pairs_per_row = np.zeros(a.gm, dtype=np.int64)
    np.add.at(pairs_per_row, seg_row, pairs_per_seg)
    cum = np.cumsum(pairs_per_row)
    total = int(cum[-1]) if cum.size else 0
    bounds = np.searchsorted(cum, np.arange(1, ndev) * (total / ndev))
    row_start = np.concatenate([[0], bounds + 1]) if ndev > 1 \
        else np.array([0])
    row_end = np.concatenate([bounds + 1, [a.gm]]) if ndev > 1 \
        else np.array([a.gm])

    a_lo = a.tptr[row_start].astype(np.int64)
    a_hi = a.tptr[row_end].astype(np.int64)
    nta_max = max(1, int((a_hi - a_lo).max()) if a.nt else 1)
    ntb_shard = max(1, cdiv(max(b.nt, 1), ndev))
    ntb_pad = ntb_shard * ndev

    ad, ao = a.dense(dtype), a.occ().astype(np.float32)
    bd, bo = b.dense(dtype), b.occ().astype(np.float32)
    a_val = np.zeros((ndev, nta_max) + ad.shape[1:], dtype=dtype)
    a_occ = np.zeros((ndev, nta_max) + ao.shape[1:], dtype=np.float32)
    for d in range(ndev):
        n = a_hi[d] - a_lo[d]
        a_val[d, :n] = ad[a_lo[d]: a_hi[d]]
        a_occ[d, :n] = ao[a_lo[d]: a_hi[d]]
    flatb = np.zeros((ntb_pad,) + bd.shape[1:], dtype=dtype)
    flato = np.zeros((ntb_pad,) + bo.shape[1:], dtype=np.float32)
    flatb[: b.nt] = bd
    flato[: b.nt] = bo
    b_val = flatb.reshape((ndev, ntb_shard) + bd.shape[1:])
    b_occ = flato.reshape((ndev, ntb_shard) + bo.shape[1:])

    seg_dev = np.searchsorted(row_start[1:], seg_row, side="right") \
        if ndev > 1 else np.zeros(sched.nt_c, dtype=np.int64)
    seg_counts = np.bincount(seg_dev, minlength=ndev)
    seg_off = np.concatenate([[0], np.cumsum(seg_counts)[:-1]])
    s_max = max(1, int(seg_counts.max()) if sched.nt_c else 1)
    pair_dev = seg_dev[sched.seg] if sched.num_pairs else np.zeros(0, np.int64)
    p_counts = np.bincount(pair_dev, minlength=ndev)
    p_max = max(1, int(p_counts.max()) if sched.num_pairs else 1)

    pa = np.zeros((ndev, p_max), dtype=np.int32)
    pb = np.zeros((ndev, p_max), dtype=np.int32)
    seg = np.full((ndev, p_max), s_max, dtype=np.int32)  # padding -> dummy
    for d in range(ndev):
        sel = pair_dev == d
        n = int(sel.sum())
        pa[d, :n] = sched.pa[sel] - a_lo[d]
        pb[d, :n] = sched.pb[sel]            # global == all-gathered index
        seg[d, :n] = sched.seg[sel] - seg_off[d]

    return DistPlan(
        ndev=ndev, a_val=a_val, a_occ=a_occ, b_val=b_val, b_occ=b_occ,
        pa=pa, pb=pb, seg=seg, s_max=s_max, seg_counts=seg_counts,
        ctrow=sched.ctrow, ctcol=sched.ctcol, schedule=sched)


def spgemm_sharded_pairs(a: TileMat, b: TileMat, mesh: Mesh, *,
                         acc_dtype=torch.float32, timer=None) -> TileMat:
    """Pair-gather distributed SpGEMM (the cross-check of the Gustavson
    formulation): B tiles all-gathered, each rank's pairs multiplied and
    summed into its C tiles (ops/numeric.py:pair_accumulate)."""
    dev, me = mesh.device, mesh.rank
    with _step(timer, "plan", dev):
        plan = plan_row_partition(a, b, mesh.size)
    with _step(timer, "upload", dev):
        ops = [_up(x[me], dev) for x in (plan.a_val, plan.a_occ, plan.b_val,
                                         plan.b_occ, plan.pa, plan.pb,
                                         plan.seg)]
    av, ao, bv, bo, pa, pb, seg = ops
    with _step(timer, "collective", dev):
        bv, bo = _all_gather(mesh, bv), _all_gather(mesh, bo)
    with _step(timer, "numeric", dev):
        cv, cc = numeric.pair_accumulate(av, ao, bv, bo, pa, pb, seg,
                                         num_segments=plan.s_max,
                                         acc_dtype=acc_dtype)
    with _step(timer, "collective", dev):
        cv, cc = _gather_outputs(mesh, cv, cc)
    with _step(timer, "assemble", dev):
        shape = (a.tm, b.tn)
        return _compact_to_tilemat(
            plan.ctrow, plan.ctcol,
            _keep(cv, plan.seg_counts, shape).astype(np.float64),
            _keep(cc, plan.seg_counts, shape), (a.m, b.n), a.tm, b.tn)


# --- Gustavson slab formulation -----------------------------------------------

@dataclasses.dataclass
class GustavsonDistPlan:
    ndev: int
    gk: int
    max_a: int          # max A tiles per (rank, k)
    max_b: int
    tm: int
    tn: int
    s_max: int
    a3_val: np.ndarray  # (D, gk, max_a*tm, tk)
    a3_occ: np.ndarray
    b3_val: np.ndarray  # (D, gk_shard, tk, max_b*tn) sharded over k
    b3_occ: np.ndarray
    seg: np.ndarray     # (D, gk*max_a*max_b) local segments, pad -> s_max
    seg_counts: np.ndarray
    ctrow: np.ndarray   # global C tile coords (concatenated rank order)
    ctcol: np.ndarray


def plan_gustavson_partition(a: TileMat, b: TileMat, ndev: int,
                             dtype=np.float32) -> GustavsonDistPlan:
    """Row-partition A (balanced by pair count) and build one Gustavson
    plan per rank; B slabs are built once and sharded over k."""
    row_start, row_end = _pair_balanced_rows(a, b, ndev)
    plans = [build_gustavson_plan(
        a.slice_tile_rows(int(row_start[d]), int(row_end[d])), b,
        dtype=dtype) for d in range(ndev)]

    gk = plans[0].gk
    tm, tk, tn = a.tm, a.tn, b.tn
    max_a = max(1, max(p.max_a for p in plans))
    max_b = max(1, max(p.max_b for p in plans))
    s_max = max(1, max(p.nt_c for p in plans))

    a3_val = np.zeros((ndev, gk, max_a * tm, tk), dtype=dtype)
    a3_occ = np.zeros_like(a3_val)
    seg = np.full((ndev, gk * max_a * max_b), s_max, dtype=np.int32)
    ctrow_parts, ctcol_parts = [], []
    for d, p in enumerate(plans):
        a3_val[d, :, : p.max_a * tm] = p.a3_val
        a3_occ[d, :, : p.max_a * tm] = p.a3_occ
        # remap seg slots (gk, p.max_a, p.max_b) -> (gk, max_a, max_b)
        src = p.seg.reshape(gk, p.max_a, p.max_b)
        dst = seg[d].reshape(gk, max_a, max_b)
        dst[:, : p.max_a, : p.max_b] = np.where(src == p.nt_c, s_max, src)
        ctrow_parts.append(p.ctrow + int(row_start[d]))
        ctcol_parts.append(p.ctcol)

    # B slabs: shared across ranks; shard over k (gk padded to a D multiple)
    bp = plans[0]
    gk_shard = cdiv(gk, ndev)
    bsrc_v = np.zeros((gk_shard * ndev, tk, max_b * tn), dtype=dtype)
    bsrc_o = np.zeros_like(bsrc_v)
    bsrc_v[:gk, :, : bp.max_b * tn] = bp.b3_val
    bsrc_o[:gk, :, : bp.max_b * tn] = bp.b3_occ
    return GustavsonDistPlan(
        ndev=ndev, gk=gk, max_a=max_a, max_b=max_b, tm=tm, tn=tn,
        s_max=s_max, a3_val=a3_val, a3_occ=a3_occ,
        b3_val=bsrc_v.reshape(ndev, gk_shard, tk, max_b * tn),
        b3_occ=bsrc_o.reshape(ndev, gk_shard, tk, max_b * tn), seg=seg,
        seg_counts=np.array([p.nt_c for p in plans]),
        ctrow=np.concatenate(ctrow_parts), ctcol=np.concatenate(ctcol_parts))


def _slab_result(a, b, plan, mesh, cv, cc, timer) -> TileMat:
    dev = mesh.device
    with _step(timer, "collective", dev):
        cv, cc = _gather_outputs(mesh, cv, cc)
    with _step(timer, "assemble", dev):
        shape = (plan.tm, plan.tn)
        return _compact_to_tilemat(
            plan.ctrow, plan.ctcol,
            _keep(cv, plan.seg_counts, shape).astype(np.float64),
            _keep(cc, plan.seg_counts, shape), (a.m, b.n), a.tm, b.tn)


def spgemm_sharded(a: TileMat, b: TileMat, mesh: Mesh, *,
                   acc_dtype=torch.float32, timer=None) -> TileMat:
    """Distributed C = A @ B over the ranks of `mesh`: A tile-rows
    partitioned per rank (pair-count balanced), B slabs sharded over the
    inner dimension and all-gathered, C tiles owner-computed with the
    Gustavson slab step (ops/gustavson.py:gustavson_core; no cross-rank
    reduction)."""
    dev, me = mesh.device, mesh.rank
    with _step(timer, "plan", dev):
        plan = plan_gustavson_partition(a, b, mesh.size)
    with _step(timer, "upload", dev):
        a3v, a3o, b3v, b3o, seg = (_up(x[me], dev) for x in (
            plan.a3_val, plan.a3_occ, plan.b3_val, plan.b3_occ, plan.seg))
    with _step(timer, "collective", dev):
        b3v = _all_gather(mesh, b3v)[: plan.gk]
        b3o = _all_gather(mesh, b3o)[: plan.gk]
    with _step(timer, "numeric", dev):
        cv, cc = gustavson_core(
            a3v, a3o, b3v, b3o, seg, gk=plan.gk, max_a=plan.max_a,
            max_b=plan.max_b, tm=plan.tm, tn=plan.tn, nt_c=plan.s_max,
            acc_dtype=acc_dtype)
    return _slab_result(a, b, plan, mesh, cv, cc, timer)


def spgemm_sharded_ring(a: TileMat, b: TileMat, mesh: Mesh, *,
                        acc_dtype=torch.float32, timer=None) -> TileMat:
    """Distributed C = A @ B with B rotated around the ring instead of
    all-gathered: each rank holds one B k-shard at a time, computes the
    partial Gustavson products for the k range it holds and passes the
    shard to its neighbour (`batch_isend_irecv`). Peak B memory per rank
    is one shard, 1/D of the all-gather formulation."""
    dev, me, ndev = mesh.device, mesh.rank, mesh.size
    with _step(timer, "plan", dev):
        plan = plan_gustavson_partition(a, b, ndev)
        gk, max_a, max_b = plan.gk, plan.max_a, plan.max_b
        gk_shard = plan.b3_val.shape[1]
        gk_pad = gk_shard * ndev
        # this rank's A slabs and segment map, padded over k to the ring
        a3v = np.zeros((gk_pad,) + plan.a3_val.shape[2:],
                       dtype=plan.a3_val.dtype)
        a3o = np.zeros_like(a3v)
        a3v[:gk] = plan.a3_val[me]
        a3o[:gk] = plan.a3_occ[me]
        seg = np.full((gk_pad, max_a * max_b), plan.s_max, dtype=np.int32)
        seg[:gk] = plan.seg[me].reshape(gk, max_a * max_b)
    with _step(timer, "upload", dev):
        a3v, a3o, seg = _up(a3v, dev), _up(a3o, dev), _up(seg, dev)
        bv, bo = _up(plan.b3_val[me], dev), _up(plan.b3_occ[me], dev)
    tm, tn = plan.tm, plan.tn
    cv = torch.zeros(plan.s_max, tm, tn, dtype=acc_dtype, device=dev)
    cc = torch.zeros_like(cv)
    for s in range(ndev):
        k0 = ((me + s) % ndev) * gk_shard
        with _step(timer, "numeric", dev):
            cv_p, cc_p = gustavson_core(
                a3v[k0: k0 + gk_shard], a3o[k0: k0 + gk_shard], bv, bo,
                seg[k0: k0 + gk_shard].reshape(-1), gk=gk_shard,
                max_a=max_a, max_b=max_b, tm=tm, tn=tn, nt_c=plan.s_max,
                acc_dtype=acc_dtype)
            cv += cv_p
            cc += cc_p
        if s + 1 < ndev:  # the last rotation's result would be discarded
            with _step(timer, "collective", dev):
                bv, bo = _ring_shift(mesh, bv), _ring_shift(mesh, bo)
    return _slab_result(a, b, plan, mesh, cv, cc, timer)


# --- strip formulation (the strip kernel per shard) ----------------------------

@dataclasses.dataclass
class StripDistPlan:
    """Per-rank strip plans with one unified kernel geometry. Each rank's
    plan is built from its own tile-row slab of A (slice_tile_rows +
    build_strip_args), B slabs are packed once and shared (b_packed=), and
    a second pass forces the maximum geometry (min_geometry=) onto the
    shards that came out smaller, so every shard's C layout and operand
    shapes agree. Unlike the reference, both plan shapes feed the kernel
    ak and slots (x1, x2): the CUDA kernel reads B slabs by ak in the
    windowed shape too, so the TPU kernel's kmin/meta are not built."""

    ndev: int
    row_lo: np.ndarray       # (D+1,) first tile-row per rank
    kwin: int | None
    gk_total: int
    kernel_kwargs: dict
    # stacked per-rank operands (mesh axis 0); None when the plan was
    # built by place_strip_partition (operands live on the device instead)
    a_val: np.ndarray | None
    a_occ: np.ndarray | None   # uint16 bfloat16 bits
    b_val: np.ndarray | None   # sharded over k; all-gathered on the device
    b_occ: np.ndarray | None
    aptr: np.ndarray | None
    x1: np.ndarray | None      # ak per A tile
    x2: np.ndarray | None      # slots per (A tile, y)
    gidx: np.ndarray | None    # (D, ntc_max) block-padded positions, pad 0
    ntc: np.ndarray            # (D,) real candidates per rank
    ctrow: np.ndarray          # global candidate coords (concatenated)
    ctcol: np.ndarray
    num_pairs: int
    rep_args: object           # one rank's StripArgs (feasibility checks)


def _strip_shard_plans(a: TileMat, b: TileMat, ndev: int, *,
                       block_rows: int = 32, window: bool | None = None):
    """The first half of the strip planners: pair-balanced tile-row slabs,
    one strip plan per shard (B packed once, shared), and the unified
    geometry every shard takes (windowed only if every shard chose it;
    mixed shards rebuild cached). The reference also falls back to the
    cached shape when the unified geometry overflows the TPU's windowed
    VMEM gate; the CUDA kernel has no such gate, so a shard's windowed
    rebuild cannot fail here. Returns (plans, row_lo, mg, windowed,
    b_packed)."""
    bptr = b.tptr.astype(np.int64)
    pair_per_tile = bptr[a.tcol.astype(np.int64) + 1] - bptr[a.tcol]
    pairs_per_row = np.zeros(a.gm, dtype=np.int64)
    np.add.at(pairs_per_row, a.trow, pair_per_tile)
    cum = np.cumsum(pairs_per_row) if a.gm else np.zeros(1, np.int64)
    total = int(cum[-1]) if cum.size else 0
    bounds = np.searchsorted(cum, np.arange(1, ndev) * (total / ndev))
    row_lo = np.concatenate([[0], np.minimum(bounds + 1, a.gm), [a.gm]])
    row_lo = np.maximum.accumulate(row_lo)

    shards = [a.slice_tile_rows(int(row_lo[d]), int(row_lo[d + 1]))
              for d in range(ndev)]
    plans = []
    b_packed = None
    for sh in shards:
        p = build_strip_args(sh, b, block_rows=block_rows, window=window,
                             b_packed=b_packed)
        if b_packed is None:
            b_packed = (p.b_val, p.b_occ)
        plans.append(p)

    windowed = all(p.kwin is not None for p in plans)
    mg = dict(max_ablock=max(p.max_ablock for p in plans),
              max_cblock=max(p.max_cblock for p in plans))
    if windowed:
        mg["kwin"] = max(p.kwin for p in plans)
    for d, p in enumerate(plans):
        same = (p.max_ablock == mg["max_ablock"]
                and p.max_cblock == mg["max_cblock"]
                and p.kwin == mg.get("kwin"))
        if not same:
            plans[d] = build_strip_args(
                shards[d], b, block_rows=block_rows, window=windowed,
                b_packed=b_packed, min_geometry=mg)
    return plans, row_lo, mg, windowed, b_packed


def _strip_geometry(plans, block_rows: int, ndev: int, b_packed):
    gm_max = max(1, max(cdiv(p.gm, block_rows) for p in plans)) * block_rows
    nt_pad = max(p.a_val.shape[0] for p in plans)
    ntc = np.array([p.nt_c for p in plans], dtype=np.int64)
    gk_total = max(p.b_val.shape[0] for p in plans)
    return dict(gm_max=gm_max, nt_pad=nt_pad, ntc=ntc,
                ntc_max=max(1, int(ntc.max())), gk_total=gk_total,
                gk_shard=cdiv(gk_total, ndev), bsh=b_packed[0].shape[1:])


def _strip_shard_arrays(p, geo: dict, mg: dict, d: int, b_packed):
    """Rank d's padded operands (a_val, a_occ, b_val, b_occ, aptr, x1, x2,
    gidx) as host arrays: its plan padded to the unified geometry and its
    k-slab of the shared packed B."""
    nt_pad, gm_max = geo["nt_pad"], geo["gm_max"]
    a_val = np.zeros((nt_pad,) + p.a_val.shape[1:], dtype=p.a_val.dtype)
    a_occ = np.zeros((nt_pad,) + p.a_occ.shape[1:], dtype=p.a_occ.dtype)
    nv = p.a_val.shape[0]
    a_val[:nv] = p.a_val
    a_occ[:nv] = p.a_occ
    aptr = np.zeros(gm_max + 1, dtype=np.int32)
    aptr[: p.aptr.size] = p.aptr
    aptr[p.aptr.size:] = p.aptr[-1]
    gidx = np.zeros(geo["ntc_max"], dtype=np.int32)
    gidx[: p.nt_c] = p.gather_idx.astype(np.int32)
    x1 = np.zeros(nt_pad, dtype=np.int32)
    x1[: p.ak.size] = p.ak
    x2 = np.full(nt_pad * p.max_b, mg["max_cblock"], dtype=np.int32)
    x2[: p.slots.size] = p.slots
    k0, gs = d * geo["gk_shard"], geo["gk_shard"]
    b_val = np.zeros((gs,) + geo["bsh"], dtype=b_packed[0].dtype)
    b_occ = np.zeros((gs,) + geo["bsh"], dtype=b_packed[1].dtype)
    src_v, src_o = b_packed[0][k0: k0 + gs], b_packed[1][k0: k0 + gs]
    b_val[: src_v.shape[0]] = src_v
    b_occ[: src_o.shape[0]] = src_o
    return a_val, a_occ, b_val, b_occ, aptr, x1, x2, gidx


def _strip_plan(plans, row_lo, mg, windowed, geo, block_rows, stacks):
    kw = plans[0].kernel_kwargs()
    kw.update(gm=geo["gm_max"], max_cblock=mg["max_cblock"],
              block_rows=block_rows)
    ctrow = np.concatenate([p.ctrow.astype(np.int64) + int(row_lo[d])
                            for d, p in enumerate(plans)])
    ctcol = np.concatenate([p.ctcol for p in plans])
    return StripDistPlan(
        ndev=len(plans), row_lo=row_lo,
        kwin=mg.get("kwin") if windowed else None,
        gk_total=geo["gk_total"], kernel_kwargs=kw, **stacks,
        ntc=geo["ntc"], ctrow=ctrow, ctcol=ctcol.astype(np.int64),
        num_pairs=sum(p.num_pairs for p in plans), rep_args=plans[0])


_STRIP_NAMES = ("a_val", "a_occ", "b_val", "b_occ", "aptr", "x1", "x2",
                "gidx")


def plan_strip_partition(a: TileMat, b: TileMat, ndev: int, *,
                         block_rows: int = 32,
                         window: bool | None = None) -> StripDistPlan:
    """Shard A by tile-row slabs (pair-count balanced), build one strip
    plan per shard, unify the geometry, and stack every rank's padded
    operands on the host ((D, nt_pad, tm, tk) and so on, B sharded over
    k). Simple, but the host holds all shards at once;
    `place_strip_partition` builds and uploads one rank's shard only."""
    plans, row_lo, mg, windowed, b_packed = _strip_shard_plans(
        a, b, ndev, block_rows=block_rows, window=window)
    geo = _strip_geometry(plans, block_rows, ndev, b_packed)
    per_rank = [_strip_shard_arrays(p, geo, mg, d, b_packed)
                for d, p in enumerate(plans)]
    stacks = {name: np.stack([arrs[i] for arrs in per_rank])
              for i, name in enumerate(_STRIP_NAMES)}
    return _strip_plan(plans, row_lo, mg, windowed, geo, block_rows, stacks)


def place_strip_partition(a: TileMat, b: TileMat, mesh: Mesh, *,
                          block_rows: int = 32, window: bool | None = None):
    """Decentralised operand staging: build only this rank's padded
    operands, upload them to its device and keep no host copy (host peak:
    one shard plus the shared packed B). Returns (arrays, plan): `arrays`
    the rank's eight tensors that spgemm_sharded_strip consumes, `plan`
    the host metadata (row_lo, ctrow/ctcol, ntc, kernel kwargs), with the
    stacked operand fields None."""
    plans, row_lo, mg, windowed, b_packed = _strip_shard_plans(
        a, b, mesh.size, block_rows=block_rows, window=window)
    geo = _strip_geometry(plans, block_rows, mesh.size, b_packed)
    arrays = _upload_strip(_strip_shard_arrays(plans[mesh.rank], geo, mg,
                                               mesh.rank, b_packed),
                           mesh.device)
    plan = _strip_plan(plans, row_lo, mg, windowed, geo, block_rows,
                       dict.fromkeys(_STRIP_NAMES))
    return arrays, plan


def _upload_strip(host, device: torch.device) -> tuple:
    """The kernel's dtypes: bfloat16 occupancy from its uint16 bits."""
    a_val, a_occ, b_val, b_occ, aptr, x1, x2, gidx = host
    return (_up(a_val, device), _u16_to_bf16(a_occ).to(device),
            _up(b_val, device), _u16_to_bf16(b_occ).to(device),
            _up(aptr, device), _up(x1, device), _up(x2, device),
            _up(gidx.astype(np.int64), device))


def spgemm_sharded_strip(a: TileMat, b: TileMat, mesh: Mesh, *,
                         block_rows: int = 32, acc_dtype=torch.float32,
                         window: bool | None = None, placed=None,
                         timer=None) -> TileMat:
    """Distributed C = A @ B running the strip kernel per shard: A
    tile-row slabs per rank (the symbolic phase sharded with them), B
    slabs all-gathered, C owner-computed and compacted on the device
    (candidate gather + occupancy bit-pack) before the all-gather that
    assembles it on every rank. Windowed and cached plan shapes both run.
    `placed` takes the (arrays, plan) pair of place_strip_partition. The
    strip kernel accumulates in float32 only (another acc_dtype raises)."""
    if acc_dtype != torch.float32:
        raise ValueError(f"the strip kernel accumulates in float32, not "
                         f"{acc_dtype}")
    dev, me = mesh.device, mesh.rank
    if placed is not None:
        arrays, plan = placed
    else:
        with _step(timer, "plan", dev):
            plan = plan_strip_partition(a, b, mesh.size,
                                        block_rows=block_rows, window=window)
        with _step(timer, "upload", dev):
            arrays = _upload_strip(
                tuple(getattr(plan, n)[me] for n in _STRIP_NAMES), dev)
    check_strip_feasible(plan.rep_args, dev)
    av, ao, bv, bo, aptr, x1, x2, gidx = arrays
    tm, tn = a.tm, b.tn
    with _step(timer, "collective", dev):
        bv = _all_gather(mesh, bv)[: plan.gk_total]
        bo = _all_gather(mesh, bo)[: plan.gk_total]
    with _step(timer, "numeric", dev):
        cv, cc = kernels.strip_numeric(av, ao, bv, bo, aptr, x1, x2,
                                       **plan.kernel_kwargs)
        if tn % 32 == 0:
            v, occ = strip_compact(cv, cc, gidx)
        else:
            v = cv.index_select(0, gidx)
            occ = (cc.index_select(0, gidx) > 0).to(torch.float32)
        del cv, cc
    with _step(timer, "collective", dev):
        v, occ = _gather_outputs(mesh, v, occ)
    with _step(timer, "assemble", dev):
        if tn % 32 == 0:
            occ = np.stack([unpack_occ_words(w, tn) for w in occ])
        return _compact_to_tilemat(
            plan.ctrow.astype(np.int32), plan.ctcol.astype(np.int32),
            _keep(v, plan.ntc, (tm, tn)).astype(np.float64),
            _keep(occ, plan.ntc, (tm, tn)).astype(np.float32),
            (a.m, b.n), tm, tn)


# --- ESC formulation (the scan kernel per row slab) ---------------------------

def spgemm_sharded_esc(a_csr: CSR, b_csr: CSR, mesh: Mesh, *, plan=None,
                       timer=None) -> CSR:
    """Distributed unstructured SpGEMM through the ESC scan kernel. Rows of
    the (R, 128) product layout map to disjoint 128-slot windows of C's
    value array, so the row slabs need no exchange of operands: each rank
    scans its own slab (ops/scan_kernels.py:esc_scan), and one all-gather
    of the scan outputs assembles C on every rank (through the one-device
    route's device window combine). Slabs split at window
    boundaries, so no window's sibling rows straddle ranks. Returns the
    CSR C. Where one window's rows overflow a rank's slab (extreme skew)
    it runs on one device, says so on stderr and counts it in
    `spgemm_sharded_esc.single_device_fallbacks`."""
    dev, ndev = mesh.device, mesh.size
    with _step(timer, "plan", dev):
        if plan is None:
            plan = build_esc_scan_plan(a_csr, b_csr, keep_sources=False)
    if plan.num_products == 0:
        return CSR(plan.c_indptr.astype(INDEX_DTYPE), plan.c_indices,
                   np.zeros(plan.nnz_c), plan.shape)
    with _step(timer, "plan", dev):
        # slabs: window-aligned, padded to the kernel block, equal per rank
        r_total = plan.qv.shape[0]
        shard_rows = -(-r_total // (ndev * SCAN_BLK)) * SCAN_BLK
        wr = plan.win_rowptr
        dev_of_win = np.minimum(wr[:-1] // shard_rows, ndev - 1)
        rows_per_win = np.diff(wr)
        rows_used = np.zeros(ndev, np.int64)
        np.add.at(rows_used, dev_of_win, rows_per_win)
    if np.any(rows_used > shard_rows):
        print("spgemm_sharded_esc: window skew overflows the per-device "
              "slab; running single-device", file=sys.stderr)
        spgemm_sharded_esc.single_device_fallbacks += 1
        return esc_scan_trim(plan, esc_scan_numeric(plan, device=dev))
    with _step(timer, "plan", dev):
        # each rank's windows are contiguous, and so are their rows: they
        # pack from the start of its slab (the reference's repack)
        first_w = np.searchsorted(dev_of_win, np.arange(ndev + 1),
                                  side="left")
        row_at = wr[first_w]          # each slab's first and last rows
        r0, r1 = int(row_at[mesh.rank]), int(row_at[mesh.rank + 1])
        qv = np.zeros((shard_rows, 128), np.float32)
        meta = np.zeros((shard_rows, 128), np.int16)
        qv[: r1 - r0] = plan.qv[r0:r1]
        meta[: r1 - r0] = meta16_plane(plan.meta[r0:r1])
    with _step(timer, "upload", dev):
        qv, meta = _up(qv, dev), _up(meta, dev)
    grows = plan.group_rows
    with _step(timer, "numeric", dev):
        out = scan_kernels.esc_scan(qv, meta, passes=plan.passes,
                                    group_rows=grows)
        del qv, meta
    with _step(timer, "collective", dev):
        out = _all_gather(mesh, out.unsqueeze(0))
    with _step(timer, "assemble", dev):
        # the slabs' rows back in the plan's row order, then the route's
        # device window combine and host trim (ops/esc.py), as the
        # one-device route; the reference sums the windows with a host
        # reduceat over every lane instead
        full = out.new_zeros(r_total // grows, 128)
        for d in range(ndev):
            lo, hi = int(row_at[d]) // grows, int(row_at[d + 1]) // grows
            full[lo:hi] = out[d, : hi - lo]
        del out
        return esc_scan_trim_combined(plan, *_combine_apply(plan, full))


spgemm_sharded_esc.single_device_fallbacks = 0


# --- Ozaki f64 formulation -------------------------------------------------------

@dataclasses.dataclass
class OzakiDistPlan:
    ndev: int
    gk: int
    max_a: int
    max_b: int
    tm: int
    tn: int
    sa: int             # unified slice counts (max over shards)
    sb: int
    s_max: int
    a_sl: np.ndarray    # (D, Sa, gk, max_a*tm, tk) int8
    a_occ: np.ndarray   # (D, gk, max_a*tm, tk) int8
    b_sl: np.ndarray    # (D, Sb, gk_shard, tk, max_b*tn) int8 (k-sharded)
    b_occ: np.ndarray   # (D, gk_shard, tk, max_b*tn) int8
    seg: np.ndarray     # (D, gk*max_a*max_b) local segments, pad -> s_max
    seg_counts: np.ndarray
    ea: np.ndarray      # (D, rows_pad) per-shard LOCAL row scale exponents
    eb: np.ndarray      # (gn*tn,) global column scale exponents
    ctrow: np.ndarray   # global C tile coords (concatenated rank order)
    ctcol: np.ndarray
    ct_local: list      # per-rank (local ctrow, ctcol) for the scaling


def plan_ozaki_partition(a: TileMat, b: TileMat, ndev: int) -> OzakiDistPlan:
    """Row-partition A (pair-count balanced, as the Gustavson plan) and
    build one Ozaki slice plan per rank. Slice counts are unified to the
    maximum over shards (padding slices are exact zeros). B is sliced once
    against its global per-column scales (the same on every shard) and
    sharded over k."""
    row_start, row_end = _pair_balanced_rows(a, b, ndev)
    shards = []
    for d in range(ndev):
        a_d = a.slice_tile_rows(int(row_start[d]), int(row_end[d]))
        base_d = build_gustavson_plan(a_d, b, dtype=np.float32, values=False)
        shards.append((a_d, base_d, slice_and_pack(a_d, b, base_d)))

    gk = shards[0][1].gk
    tm, tk, tn = a.tm, a.tn, b.tn
    max_a = max(1, max(p.max_a for _, p, _ in shards))
    max_b = max(1, max(p.max_b for _, p, _ in shards))
    s_max = max(1, max(p.nt_c for _, p, _ in shards))
    sa = max(s[4] for _, _, s in shards)
    sb = max(s[5] for _, _, s in shards)

    a_sl = np.zeros((ndev, sa, gk, max_a * tm, tk), np.int8)
    a_occ = np.zeros((ndev, gk, max_a * tm, tk), np.int8)
    seg = np.full((ndev, gk * max_a * max_b), s_max, dtype=np.int32)
    ea = np.zeros((ndev, a.gm * tm), np.int64)
    ctrow_parts, ctcol_parts, ct_local = [], [], []
    for d, (_, p, (asl_d, _, ea_d, _, sa_d, _)) in enumerate(shards):
        a_sl[d, :sa_d, :, : p.max_a * tm] = asl_d
        a_occ[d, :, : p.max_a * tm] = p.a3_occ.astype(np.int8)
        src = p.seg.reshape(gk, p.max_a, p.max_b)
        dst = seg[d].reshape(gk, max_a, max_b)
        dst[:, : p.max_a, : p.max_b] = np.where(src == p.nt_c, s_max, src)
        ea[d, : ea_d.size] = ea_d   # LOCAL to the shard
        ctrow_parts.append(p.ctrow + int(row_start[d]))
        ctcol_parts.append(p.ctcol)
        ct_local.append((np.asarray(p.ctrow), np.asarray(p.ctcol)))

    # B slices: the global column scales make every shard's B stack the
    # same: take shard 0's, pad Sb/max_b, shard over k
    p0 = shards[0][1]
    bsl0 = shards[0][2][1]                       # (sb0, gk, tk, mb0*tn)
    eb = shards[0][2][3]
    gk_shard = cdiv(gk, ndev)
    bsrc = np.zeros((sb, gk_shard * ndev, tk, max_b * tn), np.int8)
    bsrc[: bsl0.shape[0], :gk, :, : p0.max_b * tn] = bsl0
    osrc = np.zeros((gk_shard * ndev, tk, max_b * tn), np.int8)
    osrc[:gk, :, : p0.max_b * tn] = p0.b3_occ.astype(np.int8)
    b_sl = np.ascontiguousarray(
        bsrc.reshape(sb, ndev, gk_shard, tk, max_b * tn).swapaxes(0, 1))
    return OzakiDistPlan(
        ndev=ndev, gk=gk, max_a=max_a, max_b=max_b, tm=tm, tn=tn,
        sa=sa, sb=sb, s_max=s_max, a_sl=a_sl, a_occ=a_occ, b_sl=b_sl,
        b_occ=osrc.reshape(ndev, gk_shard, tk, max_b * tn), seg=seg,
        seg_counts=np.array([p.nt_c for _, p, _ in shards]), ea=ea, eb=eb,
        ctrow=np.concatenate(ctrow_parts), ctcol=np.concatenate(ctcol_parts),
        ct_local=ct_local)


def spgemm_sharded_ozaki(a: TileMat, b: TileMat, mesh: Mesh, *,
                         timer=None) -> TileMat:
    """Distributed exact-f64 C = A @ B through the Ozaki slab engine
    (ops/ozaki.py:ozaki_core): A tile-rows per rank, the int8 B slice
    stacks sharded over the inner dimension and all-gathered, C tiles
    owner-computed; the f64 scaling epilogue runs on the host per shard
    (local row scales, global column scales)."""
    dev, me = mesh.device, mesh.rank
    with _step(timer, "plan", dev):
        plan = plan_ozaki_partition(a, b, mesh.size)
    with _step(timer, "upload", dev):
        a_sl, a_occ, b_sl, b_occ, seg = (_up(x[me], dev) for x in (
            plan.a_sl, plan.a_occ, plan.b_sl, plan.b_occ, plan.seg))
    with _step(timer, "collective", dev):
        b_sl = _all_gather(mesh, b_sl, axis=1)[:, : plan.gk].contiguous()
        b_occ = _all_gather(mesh, b_occ)[: plan.gk]
    with _step(timer, "numeric", dev):
        h, m, l, cnt = ozaki_core(
            a_sl, b_sl, a_occ, b_occ, seg, gk=plan.gk, max_a=plan.max_a,
            max_b=plan.max_b, tm=plan.tm, tn=plan.tn, nt_c=plan.s_max,
            sa=plan.sa, sb=plan.sb)
        del a_sl, b_sl
    with _step(timer, "collective", dev):
        h, m, l, cnt = _gather_outputs(mesh, h, m, l, cnt)
    with _step(timer, "assemble", dev):
        vals, cnts = [], []
        for d in range(mesh.size):
            nc = int(plan.seg_counts[d])
            if nc == 0:
                continue
            v = (h[d, :nc].astype(np.float64) + m[d, :nc].astype(np.float64)
                 + l[d, :nc].astype(np.float64))
            ctr_l, ctc_l = plan.ct_local[d]
            er = plan.ea[d].reshape(-1, plan.tm)[ctr_l.astype(np.int64)]
            ec = plan.eb.reshape(-1, plan.tn)[ctc_l.astype(np.int64)]
            ex = (er[:, :, None] + ec[:, None, :] - 14).astype(np.int64)
            vals.append(np.ldexp(v, ex))
            cnts.append(cnt[d, :nc])
        keep_val = (np.concatenate(vals) if vals
                    else np.zeros((0, plan.tm, plan.tn)))
        keep_cnt = (np.concatenate(cnts) if cnts
                    else np.zeros((0, plan.tm, plan.tn), np.int32))
        return _compact_to_tilemat(plan.ctrow, plan.ctcol, keep_val,
                                   keep_cnt, (a.m, b.n), a.tm, b.tn)
