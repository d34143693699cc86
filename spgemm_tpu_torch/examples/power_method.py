"""Power iteration (dominant eigenvalue) on the SpMM strip kernel's
narrow form (port of `examples/power_method.py`). A is packed and
uploaded once; each iteration is one kernel launch whose input and
output vectors stay on the device (only the final eigenvalue reaches the
host).

The JAX example calls its SpMM kernel directly with X padded to 128
columns; here X is packed at spmm_kernels.pack_width(1) = 1 column, the
width the port's spmv uses, which runs the kernel's narrow form (reading
A by its sector map).

    python -m spgemm_tpu_torch.examples.power_method [n] [band] [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from spgemm_tpu_torch.examples import parse_args
from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import csr_to_tiles
from spgemm_tpu_torch.ops import spmm_kernels
from spgemm_tpu_torch.ops.spmm import _pack_spmm_operands
from spgemm_tpu_torch.utils.timing import resolve_device

BLOCK_ROWS = 64


def banded_spd(n: int, band: int, seed: int = 0) -> CSR:
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(r.size)
    v = np.where(r == c, np.abs(v) + band, 0.1 * v)  # diagonally dominant
    # symmetrize
    return CSR.from_coo(np.concatenate([r, c]), np.concatenate([c, r]),
                        np.concatenate([v, v]) / 2, (n, n))


class PowerStep:
    """A packed and uploaded once at 16x128 tiles; `step(x)` is one SpMV
    through the strip kernel (narrow form on CUDA, its plain version on
    the CPU) plus the normalization, with x a (n,) float32 device
    tensor. Returns (x / |A x|, x . A x)."""

    def __init__(self, a: CSR, device=None):
        self.device = resolve_device(device)
        t = csr_to_tiles(a, 16, 128)
        self.n, self.gm = a.m, t.gm
        self.width = spmm_kernels.pack_width(1)
        ops = _pack_spmm_operands(t, np.zeros((a.n, 1), np.float32),
                                  self.width, torch.float32, BLOCK_ROWS)
        self.a_dense, self.xb, self.aptr, self.ak, self.arow = \
            ops.to_device(self.device)
        self.smap = ops.sector_map_to(self.device)

    def step(self, x: torch.Tensor):
        xs = self.xb.view(-1, self.width)
        xs[: self.n, 0] = x
        y4 = spmm_kernels.spmm_strip(self.a_dense, self.xb, self.aptr,
                                     self.ak, self.arow, gm=self.gm,
                                     block_rows=BLOCK_ROWS, smap=self.smap)
        y = y4.view(-1, self.width)[: self.n, 0]
        return y / torch.linalg.vector_norm(y), torch.dot(x, y)


def power_iteration(a: CSR, iters: int = 150, device=None):
    """(lambda, final x as a (n,) float32 device tensor, the PowerStep)
    after `iters` steps from the normalized ones vector."""
    ps = PowerStep(a, device)
    x = torch.full((a.n,), 1.0 / np.sqrt(a.n), dtype=torch.float32,
                   device=ps.device)
    lam = None
    for _ in range(iters):
        x, lam = ps.step(x)          # one launch; x stays on the device
    return float(lam), x, ps


def main(argv=None) -> int:
    args = parse_args(argv, __doc__, n=8192, band=8)
    n, band = args.n, args.band
    a = banded_spd(n, band)
    print(f"A: {n}x{n}, nnz={a.nnz}")
    lam, _, _ = power_iteration(a, device=args.device)
    print(f"dominant eigenvalue (power iteration): {lam:.6f}")
    # dense reference for moderate n
    if n <= 8192:
        ref = float(np.linalg.eigvalsh(a.to_dense())[-1])
        print(f"dense reference: {ref:.6f}  "
              f"(rel err {abs(lam - ref) / abs(ref):.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
