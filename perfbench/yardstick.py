"""The yardstick: the card's published peaks and the least time a call
could take. Kept with the benchmark so that no change to the program can
move it.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): 3.35 TB/s of HBM3, 495 TFLOP/s in TF32 on the tensor cores.
TF32 is the highest published rate that yields float32 results, so no
implementation of an f32 product can read above 100% through the flop
term.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
INDEX_BYTES = 4  # int32 column indices and row pointers


def nnz_cub(a_indptr: np.ndarray, a_indices: np.ndarray,
            b_indptr: np.ndarray) -> int:
    """Products of C = A @ B: the sum over the stored entries (i, k) of A
    of the length of row k of B (TileSpGEMM's nnzCub)."""
    blen = np.diff(np.asarray(b_indptr, np.int64))
    return int(blen[np.asarray(a_indices, np.int64)].sum())


def csr_bytes(rows: int, nnz: int, value_bytes: int) -> int:
    """A CSR matrix read or written once: values, column indices and the
    row pointer."""
    return nnz * (value_bytes + INDEX_BYTES) + (rows + 1) * INDEX_BYTES


def spgemm_min_bytes(m: int, nnz_a: int, nnz_c: int, value_bytes: int,
                     nnz_b: int | None = None) -> int:
    """C = A @ B with A (m rows) and B square: A's and B's CSR read once,
    C's CSR written once. `nnz_b` None: B is A (C = A^2), whose one CSR
    is read once."""
    b = 0 if nnz_b is None else csr_bytes(m, nnz_b, value_bytes)
    return (csr_bytes(m, nnz_a, value_bytes) + b
            + csr_bytes(m, nnz_c, value_bytes))


def least_seconds(min_bytes: float, useful_flops: float) -> float:
    """The larger of the bytes over the HBM rate and the useful flops over
    the TF32 peak."""
    return max(min_bytes / HBM_BYTES_PER_S, useful_flops / TF32_FLOPS_PER_S)
