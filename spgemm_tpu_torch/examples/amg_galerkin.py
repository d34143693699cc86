"""Algebraic-multigrid Galerkin coarsening, A_coarse = P^T A P, two
spgemm_csr calls per level (A @ P, then P^T @ (A P)), each level checked
against scipy (port of `examples/amg_galerkin.py`).

Builds a 2D 5-point Poisson operator and an aggregation prolongator P
(every 2x2 node block -> one coarse aggregate). The coarse operators stay
symmetric M-matrices: the check is exact in pattern, rtol 1e-5 in values.

    python -m spgemm_tpu_torch.examples.amg_galerkin [grid_n] [levels] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from spgemm_tpu_torch.examples import parse_args
from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.ops import golden
from spgemm_tpu_torch.ops.spgemm import spgemm_csr


def poisson2d(g: int) -> CSR:
    """5-point Laplacian on a g x g grid (n = g^2)."""
    n = g * g
    idx = np.arange(n)
    i, j = idx // g, idx % g
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]
    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        ok = ((i + di >= 0) & (i + di < g) & (j + dj >= 0) & (j + dj < g))
        rows.append(idx[ok])
        cols.append((i[ok] + di) * g + (j[ok] + dj))
        vals.append(np.full(int(ok.sum()), -1.0))
    return CSR.from_coo(np.concatenate(rows), np.concatenate(cols),
                        np.concatenate(vals), (n, n))


def aggregate_p(g: int) -> CSR:
    """Tentative prolongator: 2x2 node aggregates, piecewise-constant."""
    n = g * g
    gc = (g + 1) // 2
    idx = np.arange(n)
    i, j = idx // g, idx % g
    agg = (i // 2) * gc + (j // 2)
    return CSR.from_coo(idx, agg, np.ones(n), (n, gc * gc))


def coarsen(g: int, levels: int, device=None) -> list[CSR]:
    """The coarse operators of `levels` Galerkin levels from poisson2d(g),
    each checked against scipy; raises SystemExit(1) on a mismatch."""
    a = poisson2d(g)
    out = []
    for lvl in range(levels):
        p = aggregate_p(g)
        t0 = time.perf_counter()
        ap, r1 = spgemm_csr(a, p, device=device)                  # A @ P
        rap, r2 = spgemm_csr(p.transpose(), ap, device=device)    # P^T (A P)
        ms = (time.perf_counter() - t0) * 1e3
        ref = golden.drop_explicit_zeros(
            golden.spgemm_scipy(p.transpose(), golden.spgemm_scipy(a, p)))
        got = golden.drop_explicit_zeros(rap)
        ok = (got.pattern_equal(ref)
              and np.allclose(got.data, ref.data, rtol=1e-5, atol=1e-8))
        print(f"level {lvl}: {a.m}x{a.n} (nnz {a.nnz}) -> "
              f"{rap.m}x{rap.n} (nnz {got.nnz})  {ms:.1f} ms  "
              f"backends=({r1.stats.get('backend')}, "
              f"{r2.stats.get('backend')})  "
              f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise SystemExit(1)
        out.append(got)
        a = got
        g = (g + 1) // 2
    return out


def main(argv=None) -> int:
    args = parse_args(argv, __doc__, grid_n=128, levels=2)
    coarsen(args.grid_n, args.levels, device=args.device)
    print("galerkin coarsening verified at every level")
    return 0


if __name__ == "__main__":
    sys.exit(main())
