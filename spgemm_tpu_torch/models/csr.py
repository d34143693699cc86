"""Host-side CSR container (port of `spgemm_tpu/models/csr.py`).

NumPy only. The JAX package's copy cannot be imported from here:
`spgemm_tpu/__init__.py` loads the JAX ops on import, and the port never
loads JAX. Semantics are identical, so plans built by either package from
the same CSR agree array for array (tests/test_torch_host.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np

INDEX_DTYPE = np.int32


@dataclasses.dataclass
class CSR:
    """Compressed sparse row matrix.

    indptr : (m+1,) int32 — row pointer (exclusive scan of row lengths)
    indices: (nnz,) int32 — column indices, sorted within each row
    data   : (nnz,) float — values
    shape  : (m, n)
    """

    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray
    shape: tuple[int, int]

    @staticmethod
    def from_coo(
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        shape: tuple[int, int],
        sum_duplicates: bool = True,
    ) -> "CSR":
        """Build CSR from COO triplets (any order; duplicates summed)."""
        m, n = shape
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key = rows * n + cols
            uniq_mask = np.empty(key.size, dtype=bool)
            uniq_mask[0] = True
            np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
            seg_id = np.cumsum(uniq_mask) - 1
            out_vals = np.zeros(int(seg_id[-1]) + 1, dtype=vals.dtype)
            np.add.at(out_vals, seg_id, vals)
            rows, cols, vals = rows[uniq_mask], cols[uniq_mask], out_vals
        indptr = np.zeros(m + 1, dtype=INDEX_DTYPE)
        np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
        return CSR(indptr, cols.astype(INDEX_DTYPE), vals, (m, n))

    @staticmethod
    def from_dense(dense: np.ndarray) -> "CSR":
        rows, cols = np.nonzero(dense)
        return CSR.from_coo(rows, cols, dense[rows, cols], dense.shape)

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    def row_lengths(self) -> np.ndarray:
        return self.indptr[1:] - self.indptr[:-1]

    def rows_expanded(self) -> np.ndarray:
        """Per-nonzero row index (the COO row array), (nnz,) int64."""
        return np.repeat(
            np.arange(self.m, dtype=np.int64), self.row_lengths().astype(np.int64)
        )

    def transpose(self) -> "CSR":
        """CSR of A^T via histogram + scan + stable counting sort."""
        m, n = self.shape
        order = np.argsort(self.indices, kind="stable")
        t_indices = self.rows_expanded()[order].astype(INDEX_DTYPE)
        t_data = self.data[order]
        t_indptr = np.zeros(n + 1, dtype=INDEX_DTYPE)
        np.cumsum(np.bincount(self.indices, minlength=n), out=t_indptr[1:])
        return CSR(t_indptr, t_indices, t_data, (n, m))

    def to_dense(self) -> np.ndarray:
        """Dense (m, n) array; duplicate entries (possible before
        canonicalization) are summed."""
        dense = np.zeros(self.shape, dtype=self.data.dtype)
        np.add.at(dense, (self.rows_expanded(), self.indices), self.data)
        return dense

    def with_data(self, data: np.ndarray) -> "CSR":
        if data.shape != self.data.shape:
            raise ValueError(f"data shape {data.shape} != {self.data.shape}")
        return CSR(self.indptr, self.indices, data, self.shape)

    def with_sequential_values(self, modulus: int = 10) -> "CSR":
        """Overwrite values with `i % modulus` (i = nonzero ordinal), the
        reference main program's synthetic value model (main.cu:111-112):
        integer-exact in f32."""
        return self.with_data(
            (np.arange(self.nnz, dtype=np.int64) % modulus).astype(np.float64)
        )

    def sorted_dedup(self) -> "CSR":
        """Canonicalize: sort column indices within rows, sum duplicates."""
        return CSR.from_coo(
            self.rows_expanded(), self.indices, self.data, self.shape
        )

    def __eq__(self, other: object) -> bool:  # structural + value equality
        if not isinstance(other, CSR):
            return NotImplemented
        return (
            self.shape == other.shape
            and np.array_equal(self.indptr, other.indptr)
            and np.array_equal(self.indices, other.indices)
            and np.array_equal(self.data, other.data)
        )

    def pattern_equal(self, other: "CSR") -> bool:
        """nnz + rowptr + colidx equality."""
        return (
            self.shape == other.shape
            and self.nnz == other.nnz
            and np.array_equal(self.indptr, other.indptr)
            and np.array_equal(self.indices, other.indices)
        )

    def allclose(self, other: "CSR", rtol: float = 1e-12, atol: float = 0.0) -> bool:
        """Pattern equality plus value closeness."""
        return self.pattern_equal(other) and np.allclose(
            self.data, other.data, rtol=rtol, atol=atol
        )


def flop_count_spgemm(a: CSR, b: CSR) -> int:
    """nnzCub = sum over nonzeros (i,k) of A of row-length k of B, the
    FLOP-count base of GFLOPS = 2*nnzCub/time."""
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    return int(b.row_lengths().astype(np.int64)[a.indices].sum())
