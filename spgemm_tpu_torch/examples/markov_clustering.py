"""Markov clustering (MCL): alternate expansion (M = M @ M, a SpGEMM) and
inflation (elementwise power and column normalization); the attractor
with the most flow in each column labels its node (port of
`examples/markov_clustering.py`).

    python -m spgemm_tpu_torch.examples.markov_clustering [n_nodes] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from spgemm_tpu_torch.examples import parse_args
from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.ops.spgemm import spgemm_csr


def clustered_graph(n: int, n_clusters: int = 8, seed: int = 0) -> CSR:
    rng = np.random.default_rng(seed)
    size = n // n_clusters
    rows, cols = [], []
    for c in range(n_clusters):
        base = c * size
        m = size * 16
        rows.append(base + rng.integers(0, size, m))
        cols.append(base + rng.integers(0, size, m))
    # sparse inter-cluster noise
    rows.append(rng.integers(0, n, n // 16))
    cols.append(rng.integers(0, n, n // 16))
    r = np.concatenate(rows)
    c = np.concatenate(cols)
    keep = r != c
    r, c = r[keep], c[keep]
    rows = np.concatenate([r, c, np.arange(n)])  # symmetric + self loops
    cols = np.concatenate([c, r, np.arange(n)])
    return CSR.from_coo(rows, cols, np.ones(rows.size), (n, n))


def col_normalize_inflate(m: CSR, r: float = 2.0, prune: float = 1e-4) -> CSR:
    vals = np.power(np.abs(m.data), r)
    colsum = np.zeros(m.n)
    np.add.at(colsum, m.indices, vals)
    vals = vals / np.maximum(colsum[m.indices], 1e-300)
    keep = vals > prune
    rows = m.rows_expanded()[keep]
    return CSR.from_coo(rows, m.indices[keep], vals[keep], m.shape)


def mcl(adj: CSR, iters: int = 12, device=None) -> np.ndarray:
    """Cluster labels (the attractor row of each column), -1 where a
    column kept no flow."""
    m = col_normalize_inflate(adj, r=1.0, prune=0.0)
    for it in range(iters):
        m2, res = spgemm_csr(m, tm=16, tn=128, device=device)  # expansion
        m = col_normalize_inflate(m2)                          # inflation
        print(f"  iter {it}: nnz={m.nnz} backend={res.stats['backend']}")
    # node j joins the cluster of the attractor with max flow in col j
    labels = np.full(adj.m, -1)
    best = np.full(adj.m, -1.0)
    rows = m.rows_expanded()
    for r, c, v in zip(rows, m.indices, m.data):
        if v > best[c]:
            best[c] = v
            labels[c] = r
    return labels


def main(argv=None) -> int:
    args = parse_args(argv, __doc__, n_nodes=1024)
    n = args.n_nodes
    adj = clustered_graph(n)
    print(f"graph: {n} nodes, {adj.nnz} edges, 8 planted clusters")
    labels = mcl(adj, device=args.device)
    n_found = np.unique(labels[labels >= 0]).size
    print(f"clusters found: {n_found} (8 planted; granularity is set "
          f"by the inflation power r)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
