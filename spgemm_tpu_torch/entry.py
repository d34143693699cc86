"""Compile-check entry point (port of `__graft_entry__.py:entry`).

    fn, args = entry()          # tensors on CUDA
    c_val, c_cnt = fn(*args)

`fn` is the pair backend's numeric step, ops/numeric.py:pair_accumulate
(torch ops, as the JAX entry uses its XLA `pair_accumulate`), on the
same 128x128 problem at 16x16 tiles: dense A tiles, their 0/1
occupancy, and the pair schedule of C = A^2. The multi-device dry run
waits for the port's multi-device slice.
"""

from __future__ import annotations

import numpy as np
import torch

from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import TileMat, csr_to_tiles
from spgemm_tpu_torch.ops.numeric import pair_accumulate
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
