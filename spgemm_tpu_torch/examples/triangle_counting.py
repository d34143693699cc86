"""Triangle counting through SpGEMM: for an undirected graph with
adjacency A, the triangle count is sum(A .* A^2) / 6 (port of
`examples/triangle_counting.py`).

    python -m spgemm_tpu_torch.examples.triangle_counting [n_nodes] [avg_degree] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from spgemm_tpu_torch.examples import parse_args
from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.ops.spgemm import spgemm_csr


def random_graph(n: int, deg: int, seed: int = 0) -> CSR:
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    # symmetrize, unit weights
    rows = np.concatenate([r, c])
    cols = np.concatenate([c, r])
    return CSR.from_coo(rows, cols, np.ones(rows.size), (n, n))


def count_triangles(adj: CSR, device=None) -> int:
    """sum(A .* A^2) / 6 with A^2 on `device` (None: CUDA)."""
    # binarize (duplicate edges summed by from_coo)
    adj = CSR(adj.indptr, adj.indices, np.ones(adj.nnz), adj.shape)
    a2, res = spgemm_csr(adj, tm=16, tn=128, device=device)
    print(f"  A^2: nnz={a2.nnz}  backend={res.stats['backend']}  "
          f"numeric={res.timings_ms.get('numeric_ms', 0):.2f} ms")
    # sum(A .* A^2): A and A^2 rows are column-sorted, so one global
    # searchsorted over (row, col) keys aligns every A entry with its A^2
    # slot (if present)
    n64 = np.int64(adj.n)
    key_a = adj.rows_expanded().astype(np.int64) * n64 + adj.indices
    key_2 = a2.rows_expanded().astype(np.int64) * n64 + a2.indices
    pos = np.searchsorted(key_2, key_a)
    pos = np.clip(pos, 0, max(0, key_2.size - 1))
    total = (float(a2.data[pos][key_2[pos] == key_a].sum())
             if key_2.size else 0.0)
    return int(round(total / 6))


def main(argv=None) -> int:
    args = parse_args(argv, __doc__, n_nodes=2000, avg_degree=16)
    n, deg = args.n_nodes, args.avg_degree
    adj = random_graph(n, deg)
    print(f"graph: {n} nodes, {adj.nnz} directed edges")
    t = count_triangles(adj, device=args.device)
    print(f"triangles: {t}")
    # verify against a dense reference for small graphs
    if n <= 4000:
        d = (adj.to_dense() > 0).astype(np.float64)
        ref = int(round(np.sum(d * (d @ d)) / 6))
        print(f"dense reference: {ref}  ({'OK' if ref == t else 'MISMATCH'})")
        return 0 if ref == t else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
