"""Deterministic converter test fixtures (the port's counterpart of the
JAX package's `tools/generate_fixtures.py`): the five 36x36 pattern
families of the reference's `UnitTest/CSR2TILE/generate_matrix.py`
(diagonal, tridiagonal, banded, random at three densities,
symmetric-sparse), each written as .mtx (`io/mmio.py:write_mtx`) plus a
golden per-row bitmask file: uint32 words, LSB = lowest column. The
words are the occupancy masks of the matrix cut as one 36x36 tile
(`TileMat.mask`, `TileMat.mask_words` words per row), which equal the
row bitmasks the JAX tool computes from the dense matrix; the output is
byte for byte the JAX tool's.

Usage (from the repository root):
  python -m spgemm_tpu_torch.tools.generate_fixtures [outdir]
"""

from __future__ import annotations

import os
import sys

import numpy as np

from spgemm_tpu_torch.io.mmio import write_mtx
from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import csr_to_tiles

N = 36


def diagonal(rng):
    d = np.zeros((N, N))
    np.fill_diagonal(d, rng.uniform(1, 10, N))
    return d


def tridiagonal(rng):
    d = diagonal(rng)
    idx = np.arange(N - 1)
    d[idx, idx + 1] = rng.uniform(0.1, 2, N - 1)
    d[idx + 1, idx] = rng.uniform(0.1, 2, N - 1)
    return d


def banded(rng, bw=5):
    d = np.zeros((N, N))
    for k in range(-bw, bw + 1):
        idx = np.arange(max(0, -k), min(N, N - k))
        vals = rng.uniform(0.1, 2, idx.size)
        if k == 0:
            vals = rng.uniform(1, 10, idx.size)
        d[idx, idx + k] = vals
    return d


def random_density(rng, density):
    d = np.zeros((N, N))
    mask = rng.random((N, N)) < density
    d[mask] = rng.uniform(0.1, 10, mask.sum())
    np.fill_diagonal(d, rng.uniform(1, 10, N))
    return d


def symmetric_sparse(rng, density=0.05):
    d = random_density(rng, density)
    d = np.triu(d)
    return d + np.triu(d, 1).T


FAMILIES = {
    "diagonal_36x36": diagonal,
    "tridiagonal_36x36": tridiagonal,
    "banded_36x36": banded,
    "random_0.05_36x36": lambda rng: random_density(rng, 0.05),
    "random_0.1_36x36": lambda rng: random_density(rng, 0.10),
    "random_0.15_36x36": lambda rng: random_density(rng, 0.15),
    "sparse_symmetric_36x36": symmetric_sparse,
}


def row_bitmask_words(csr: CSR) -> np.ndarray:
    """Whole-matrix per-row occupancy as uint32 words, LSB-first: the
    masks of the matrix cut as one N x N tile."""
    t = csr_to_tiles(csr, N, N)
    if t.nt != 1:
        raise ValueError(f"expected one {N}x{N} tile, got {t.nt}")
    return t.mask.reshape(N, t.mask_words)


def main(outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(42)
    for name, fn in FAMILIES.items():
        csr = CSR.from_dense(fn(rng))
        write_mtx(os.path.join(outdir, name + ".mtx"), csr,
                  comment=f"{name} fixture (seed 42)")
        words = row_bitmask_words(csr)
        with open(os.path.join(outdir, name + ".bitmask"), "w") as f:
            f.write("# uint32 words per row, LSB = column 0\n")
            for r in range(words.shape[0]):
                f.write(" ".join(f"{w:08x}" for w in words[r]) + "\n")
        print(f"{name}: nnz={csr.nnz}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else
         os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
             os.path.abspath(__file__)))), "tests", "fixtures"))
