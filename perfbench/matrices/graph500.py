"""A Graph500 Kronecker graph (graph500.org specification, the reference
`kronecker_generator.m`): 2^scale vertices and edgefactor * 2^scale edges,
each edge placed by `scale` draws over the initiator (A, B, C, D), the
vertex labels then permuted at random. Kernel 1's undirected graph:
every edge stored both ways, duplicates merged, self-loops kept.

The graph is drawn from the config's own `graph_seed`, so every run seed
multiplies the same graph; the traffic relabels it and draws its
weights from the run's seed: uniform in [0, 1) as for the SSSP kernel,
one per undirected edge, so A(i, j) and A(j, i) share one value."""

from __future__ import annotations

import numpy as np
import torch


def kronecker_edges(scale: int, edgefactor: int, a: float, b: float,
                    c: float, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(start, end) vertex arrays of the edge list."""
    rng = np.random.default_rng(seed)
    n_edges = edgefactor << scale
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    ij = np.zeros((2, n_edges), np.int64)
    for level in range(scale):
        ii = rng.random(n_edges) > ab
        jj = rng.random(n_edges) > np.where(ii, c_norm, a_norm)
        ij[0] += ii.astype(np.int64) << level
        ij[1] += jj.astype(np.int64) << level
    ij = rng.permutation(1 << scale)[ij]
    ij = ij[:, rng.permutation(n_edges)]
    return ij[0], ij[1]


class Graph:
    """The symmetrised, deduplicated graph as int32 CSR arrays, columns
    sorted."""

    def __init__(self, indptr, indices, n):
        self.indptr, self.indices, self.shape = indptr, indices, (n, n)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        # each stored (i, j) takes the value drawn for the one of (i, j)
        # and (j, i) that comes first in storage order
        key = rows * n + indices
        mirror = np.searchsorted(key, indices.astype(np.int64) * n + rows)
        self.owner = np.minimum(np.arange(key.size), mirror)

    def values(self, g: torch.Generator, dtype) -> torch.Tensor:
        v = torch.rand(self.indices.size, generator=g, device=g.device,
                       dtype=dtype)
        return v[torch.from_numpy(self.owner).to(g.device)]


def build(cfg: dict) -> Graph:
    scale = int(cfg["scale"])
    n = 1 << scale
    a, b, c = (float(cfg["initiator"][k]) for k in ("A", "B", "C"))
    u, v = kronecker_edges(scale, int(cfg["edgefactor"]), a, b, c,
                           int(cfg["graph_seed"]))
    key = np.unique(np.concatenate([u * n + v, v * n + u]))
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(key // n, minlength=n), out=indptr[1:])
    return Graph(indptr, (key % n).astype(np.int32), n)
