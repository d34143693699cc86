"""PageRank on an R-MAT scale-free graph, the unstructured workload: a
power-law adjacency has about one nonzero per 16x128 tile, so the
iteration runs on the gather SpMM (`spmm_gather`: raw CSR, no tiles) and
the two-hop reachability count at the end on the ESC SpGEMM engine (port
of `examples/pagerank.py`).

    python -m spgemm_tpu_torch.examples.pagerank [n] [avg_degree] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from spgemm_tpu_torch.examples import parse_args
from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.ops.esc import spgemm_esc
from spgemm_tpu_torch.ops.spmm import spmm_gather
from spgemm_tpu_torch.utils.generators import rmat
from spgemm_tpu_torch.utils.timing import resolve_device

DAMPING, TOL, MAX_ITERS = 0.85, 1e-8, 100


def transition(g: CSR) -> tuple[CSR, np.ndarray]:
    """(P = A^T D^-1, the dangling-node mask): rows normalized by their
    weight sum (R-MAT multi-edges carry summed weights)."""
    row_sum = np.zeros(g.n)
    np.add.at(row_sum, g.rows_expanded(), g.data)
    p = CSR(g.indptr, g.indices,
            g.data / np.maximum(row_sum, 1e-300)[g.rows_expanded()],
            g.shape).transpose()
    return p, row_sum == 0


def pagerank(g: CSR, device=None):
    """(ranks (n, 1) float32, iterations run): the power iteration with
    one spmm_gather per step until the L1 change falls below TOL."""
    dev = resolve_device(device)
    n = g.n
    p, dangling = transition(g)
    dangling = torch.from_numpy(dangling).to(dev)
    d = DAMPING
    x = torch.full((n, 1), 1.0 / n, dtype=torch.float32, device=dev)
    for it in range(MAX_ITERS):
        leak = d * float(x[dangling].sum())   # dangling-node mass
        x_new = (d * spmm_gather(p, x.cpu().numpy(), device=dev)
                 + (leak + 1 - d) / n)
        delta = float((x_new - x).abs().sum())
        x = x_new
        if delta < TOL:
            break
    return x.cpu().numpy(), it + 1


def main(argv=None) -> int:
    args = parse_args(argv, __doc__, n=16384, avg_degree=16)
    n, deg = args.n, args.avg_degree
    g = rmat(np.random.default_rng(7), n, deg, values="ones")
    print(f"R-MAT graph: n={n} edges={g.nnz} "
          f"max out-degree={int(np.diff(g.indptr).max())}")
    t0 = time.perf_counter()
    x, iters = pagerank(g, device=args.device)
    dt = time.perf_counter() - t0
    top = np.argsort(-x[:, 0])[:5]
    print(f"converged in {iters} iterations ({dt:.2f} s)")
    print("top-5 ranks:", ", ".join(
        f"v{int(v)}={x[v, 0]:.2e}" for v in top))

    # two-hop reachability pattern through the ESC SpGEMM engine
    c2, tms, plan = spgemm_esc(g, g, device=args.device)
    print(f"two-hop pairs (A^2 pattern): {c2.nnz} "
          f"(products {plan.num_products}, numeric "
          f"{tms['numeric_ms']:.1f} ms)")

    # sanity: PageRank sums to 1
    ok = abs(float(x.sum()) - 1.0) < 1e-3
    print("OK" if ok else f"MISMATCH: ranks sum to {float(x.sum())}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
