"""The stiffness matrix of top3d's cantilever (Liu and Tovar, "An
efficient 3D topology optimization code written in Matlab", Struct.
Multidisc. Optim. 50, 2014): a box of nelx x nely x nelz unit cubes,
eight-node hexahedra with three displacement DOFs per node, the face
x = 0 fixed and its DOFs removed, K(free, free) as the solver takes it.

Nodes are numbered as top3d numbers them: y fastest (from the top down),
then x, then z, node (i, j, k) at k (nelx+1)(nely+1) + i (nely+1) +
(nely - j), DOFs 3 node + (0, 1, 2). The element stiffness KE is the
isotropic trilinear element of E = 1 and Poisson's ratio nu on a unit
cube, integrated exactly by 2x2x2 Gauss points (top3d's lk_H8 is the
same matrix in closed form). None of its 576 entries is zero, so the
pattern couples every pair of DOFs whose nodes share an element.

The values are SIMP's: element e contributes E_e KE with E_e = Emin +
x_e^penal (E0 - Emin); each draw takes fresh densities x_e, uniform in
[0, 1), as an optimisation's iterations re-assemble K over a fixed mesh.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch


def element_stiffness(nu: float) -> tuple[np.ndarray, np.ndarray]:
    """(KE 24 x 24, the element's 8 corners as (x, y, z) offsets), DOFs
    ordered corner-major, x y z within a corner."""
    lam = nu / ((1 + nu) * (1 - 2 * nu))
    mu = 1 / (2 * (1 + nu))
    d = np.zeros((6, 6))
    d[:3, :3] = lam
    d[range(3), range(3)] += 2 * mu
    d[range(3, 6), range(3, 6)] = mu
    corners = np.array([(x, y, z) for z, y, x in
                        itertools.product((0, 1), repeat=3)])
    gauss = (0.5 - 0.5 / np.sqrt(3), 0.5 + 0.5 / np.sqrt(3))
    ke = np.zeros((24, 24))
    for p in itertools.product(gauss, repeat=3):
        p = np.array(p)
        f = np.where(corners == 1, p, 1 - p)       # (8, 3) factors
        s = np.where(corners == 1, 1.0, -1.0)      # their derivatives
        dn = np.stack([s[:, 0] * f[:, 1] * f[:, 2],
                       f[:, 0] * s[:, 1] * f[:, 2],
                       f[:, 0] * f[:, 1] * s[:, 2]], 1)
        b = np.zeros((6, 24))
        for a, (bx, by, bz) in enumerate(dn):
            b[0, 3 * a], b[1, 3 * a + 1], b[2, 3 * a + 2] = bx, by, bz
            b[3, 3 * a], b[3, 3 * a + 1] = by, bx
            b[4, 3 * a + 1], b[4, 3 * a + 2] = bz, by
            b[5, 3 * a], b[5, 3 * a + 2] = bz, bx
        ke += b.T @ d @ b / 8
    return ke, corners


class Stiffness:
    """K(free, free) as int32 CSR arrays, columns sorted, and the map from
    each element's KE entries to the CSR positions they add into."""

    def __init__(self, cfg: dict):
        nelx, nely, nelz = (int(cfg[k]) for k in ("nelx", "nely", "nelz"))
        self.e0, self.emin = float(cfg["E0"]), float(cfg["Emin"])
        self.penal = float(cfg["penal"])
        ke, corners = element_stiffness(float(cfg["nu"]))
        self.ke = ke.ravel()
        ex, ey, ez = (a.ravel() for a in np.meshgrid(
            np.arange(nelx), np.arange(nely), np.arange(nelz),
            indexing="ij"))
        self.n_elements = ex.size
        node = lambda i, j, k: (k * (nelx + 1) * (nely + 1)
                                + i * (nely + 1) + (nely - j))
        nodes = np.stack([node(ex + cx, ey + cy, ez + cz)
                          for cx, cy, cz in corners], 1)
        edof = (3 * nodes[:, :, None] + np.arange(3)).reshape(-1, 24)
        n_dof = 3 * (nelx + 1) * (nely + 1) * (nelz + 1)
        fixed = np.zeros(n_dof, bool)
        jj, kk = np.meshgrid(np.arange(nely + 1), np.arange(nelz + 1))
        fixed[(3 * node(0, jj, kk).reshape(-1, 1) + np.arange(3)).ravel()] = 1
        free_id = np.cumsum(~fixed) - 1
        free_id[fixed] = -1
        n = int((~fixed).sum())
        la, lb = np.divmod(np.arange(576), 24)
        r, c = free_id[edof[:, la]], free_id[edof[:, lb]]
        keep = (r >= 0) & (c >= 0)
        key = r.astype(np.int64) * n + c
        uniq, pos = np.unique(key[keep], return_inverse=True)
        self.indptr = np.zeros(n + 1, np.int32)
        np.cumsum(np.bincount(uniq // n, minlength=n), out=self.indptr[1:])
        self.indices = (uniq % n).astype(np.int32)
        self.shape = (n, n)
        self.flat = np.flatnonzero(keep)   # element * 576 + entry
        self.pos = pos.astype(np.int64)    # its CSR position

    def values(self, g: torch.Generator, dtype) -> torch.Tensor:
        dev = g.device
        x = torch.rand(self.n_elements, generator=g, device=dev,
                       dtype=torch.float64)
        e = self.emin + x.pow(self.penal) * (self.e0 - self.emin)
        ke = torch.from_numpy(self.ke).to(dev)
        w = (e[:, None] * ke[None, :]).reshape(-1)
        w = w[torch.from_numpy(self.flat).to(dev)]
        v = torch.zeros(self.indices.size, dtype=torch.float64, device=dev)
        v.index_add_(0, torch.from_numpy(self.pos).to(dev), w)
        return v.to(dtype)


def build(cfg: dict) -> Stiffness:
    return Stiffness(cfg)
