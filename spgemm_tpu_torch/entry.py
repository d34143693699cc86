"""Compile-check entry point and multi-device dry run (port of
`__graft_entry__.py`).

    fn, args = entry()          # tensors on CUDA
    c_val, c_cnt = fn(*args)
    dryrun_multichip(4)         # one card per rank, NCCL

`fn` is the pair backend's numeric step, ops/numeric.py:pair_accumulate
(torch ops, as the JAX entry uses its XLA `pair_accumulate`), on the
same 128x128 problem at 16x16 tiles: dense A tiles, their 0/1
occupancy, and the pair schedule of C = A^2. `dryrun_multichip(n)` runs
every sharded formulation of parallel/dist.py on n ranks and checks each
C against the host golden model.
"""

from __future__ import annotations

import numpy as np
import torch

import torch.distributed as dist

from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import TileMat, csr_to_tiles, tiles_to_csr
from spgemm_tpu_torch.ops import golden
from spgemm_tpu_torch.ops.numeric import pair_accumulate
from spgemm_tpu_torch.parallel import dist as pdist
from spgemm_tpu_torch.ops.symbolic import build_pair_schedule
from spgemm_tpu_torch.utils.timing import resolve_device


def _example_problem(m: int = 128, density: float = 0.05,
                     seed: int = 0) -> TileMat:
    rng = np.random.default_rng(seed)
    nnz = int(m * m * density)
    a = CSR.from_coo(
        rng.integers(0, m, nnz),
        rng.integers(0, m, nnz),
        rng.integers(1, 10, nnz).astype(np.float64),
        (m, m),
    )
    return csr_to_tiles(a, 16, 16)


def entry(device=None):
    """(fn, example_args) with the tensors on `device` (None means CUDA;
    raises without a card)."""
    dev = resolve_device(device)
    at = _example_problem()
    sched = build_pair_schedule(at, at)
    up = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    a_val = up(at.dense(np.float32))
    a_occ = up(at.occ().astype(np.float32))
    pa, pb, seg = up(sched.pa), up(sched.pb), up(sched.seg)

    def fn(a_val, a_occ, pa, pb, seg):
        return pair_accumulate(a_val, a_occ, a_val, a_occ, pa, pb, seg,
                               num_segments=sched.nt_c)

    return fn, (a_val, a_occ, pa, pb, seg)


def _check(c: CSR, ref: CSR, tag: str, *, rtol: float = 1e-5,
           atol: float = 1e-8, exact: bool = False) -> None:
    if not c.pattern_equal(ref):
        raise AssertionError(f"multichip {tag}: pattern mismatch")
    if exact:
        np.testing.assert_array_equal(c.data, ref.data)
    else:
        np.testing.assert_allclose(c.data, ref.data, rtol=rtol, atol=atol)


def _dryrun_checks(n_devices: int, device=None) -> int:
    """One rank's share of the dry run: every formulation, square and
    rectangular, on this process's mesh (the reference's problems; the
    strip shards at 16x128 / 128x128 tiles, the strip kernel's, where the
    reference uses 16x16). Raises on any mismatch; returns nnz(C)."""
    mesh = pdist.make_mesh(n_devices, device=device)
    # 4 blocks of block_rows=2 tile-rows per rank at n_devices=8
    m = max(96, n_devices * 2 * 2 * 16 * 2)
    at = _example_problem(m=m, density=600 / (m * m), seed=1)
    a_csr = tiles_to_csr(at)
    ref = golden.spgemm_dense_row(a_csr, a_csr)
    at_s, bt_s = csr_to_tiles(a_csr, 16, 128), csr_to_tiles(a_csr, 128, 128)

    _check(tiles_to_csr(pdist.spgemm_sharded(at, at, mesh)), ref,
           "gustavson")
    _check(tiles_to_csr(pdist.spgemm_sharded_strip(at_s, bt_s, mesh,
                                                   block_rows=2)),
           ref, "strip")
    _check(tiles_to_csr(pdist.spgemm_sharded_ring(at, at, mesh)), ref,
           "ring")
    ref_nz = golden.drop_explicit_zeros(ref)
    _check(golden.drop_explicit_zeros(
        pdist.spgemm_sharded_esc(a_csr, a_csr, mesh)), ref_nz, "esc",
        rtol=1e-4, atol=1e-6)

    # rectangular A @ B with empty-ish shards at the tail
    rng = np.random.default_rng(3)
    ar = CSR.from_coo(rng.integers(0, m, 500), rng.integers(0, m // 2, 500),
                      rng.integers(1, 10, 500).astype(np.float64),
                      (m, m // 2))
    br = CSR.from_coo(rng.integers(0, m // 2, 400),
                      rng.integers(0, m * 2, 400),
                      rng.integers(1, 10, 400).astype(np.float64),
                      (m // 2, m * 2))
    ref_r = golden.spgemm_dense_row(ar, br)
    _check(tiles_to_csr(pdist.spgemm_sharded_strip(
        csr_to_tiles(ar, 16, 128), csr_to_tiles(br, 128, 128), mesh,
        block_rows=2)), ref_r, "rect", atol=0.0)
    c_r2 = tiles_to_csr(pdist.spgemm_sharded_ring(
        csr_to_tiles(ar, 16, 16), csr_to_tiles(br, 16, 16), mesh))
    if not c_r2.pattern_equal(ref_r):
        raise AssertionError("multichip rect ring: mismatch")

    # exact f64 through the Ozaki slab engine (bit-exact on integers)
    c_oz = pdist.spgemm_sharded_ozaki(at_s, bt_s, mesh)
    _check(golden.drop_explicit_zeros(tiles_to_csr(c_oz)), ref_nz,
           "ozaki", exact=True)
    return ref.nnz


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run every sharded formulation (slab all-gather, strip kernel, ring,
    ESC, Ozaki f64; square and rectangular) on `n_devices` ranks, with a
    problem large enough that every rank owns several strip blocks, and
    check each C against the host golden model; prints one OK line.

    `device` None runs one card per rank over NCCL and raises with fewer
    than `n_devices` cards; "cpu" runs gloo ranks on the host. Inside an
    initialised process group of `n_devices` ranks (torchrun) each rank
    runs its share in place; otherwise `n_devices` processes are spawned."""
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        resolve_device(device)
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs one card "
                               f"per rank; {torch.cuda.device_count()} "
                               "present")
    rank_device = "cpu" if on_cpu else None
    if dist.is_initialized():
        nnz = _dryrun_checks(n_devices, rank_device)
        if dist.get_rank() != 0:
            return
    else:
        nnz = pdist.spawn_ranks(_dryrun_checks, n_devices,
                                backend="gloo" if on_cpu else "nccl",
                                args=(n_devices, rank_device))[0]
    print(f"dryrun_multichip({n_devices}): OK — nnzC={nnz} "
          f"(gustavson + strip + ring + esc + ozaki-f64, "
          f"square + rectangular)")
