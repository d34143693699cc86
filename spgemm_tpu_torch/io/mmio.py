"""Matrix Market (.mtx) reader producing CSR, and writer (port of
`spgemm_tpu/io/mmio.py:read_mtx, write_mtx`).

Parses the MatrixMarket banner, handles real / integer / pattern /
complex fields, expands symmetric / skew-symmetric / hermitian storage to
both triangles, converts 1-based to 0-based indices, and returns a
canonical (row-sorted, column-sorted, duplicate-summed) CSR.
"""

from __future__ import annotations

import gzip
import io
import os

import numpy as np

from spgemm_tpu_torch.models.csr import CSR

_VALID_FORMATS = {"coordinate", "array"}
_VALID_FIELDS = {"real", "integer", "pattern", "complex"}
_VALID_SYMMETRIES = {"general", "symmetric", "skew-symmetric", "hermitian"}


class MatrixMarketError(ValueError):
    pass


def _open(path: str | os.PathLike):
    path = os.fspath(path)
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_mtx(
    path: str | os.PathLike,
    expand_symmetric: bool = True,
    dtype=np.float64,
) -> tuple[CSR, bool]:
    """Read a Matrix Market file into CSR.

    Returns (csr, is_symmetric). When `expand_symmetric` (the default, as in
    the reference), symmetric/hermitian/skew storage is expanded to both
    triangles; `is_symmetric` still reports the file's declared symmetry —
    the reference's main program uses it to refuse AAT on symmetric inputs
    (`src/main.cu:120-124`).

    Complex matrices are read as their real part (the reference does the
    same: it reads only the first value column for complex,
    `mmio_highlevel.h:640-664` analog).
    """
    with _open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise MatrixMarketError(f"missing MatrixMarket banner in {path}")
        parts = header.strip().split()
        if len(parts) < 5 or parts[1].lower() != "matrix":
            raise MatrixMarketError(f"unsupported banner: {header!r}")
        fmt, field, symmetry = (
            parts[2].lower(),
            parts[3].lower(),
            parts[4].lower(),
        )
        if fmt not in _VALID_FORMATS:
            raise MatrixMarketError(f"unsupported format {fmt!r}")
        if field not in _VALID_FIELDS:
            raise MatrixMarketError(f"unsupported field {field!r}")
        if symmetry not in _VALID_SYMMETRIES:
            raise MatrixMarketError(f"unsupported symmetry {symmetry!r}")

        # Skip comments / blank lines to the size line.
        line = f.readline()
        while line and (line.startswith("%") or not line.strip()):
            line = f.readline()
        if not line:
            raise MatrixMarketError("missing size line")
        size = line.split()

        if fmt == "array":
            m, n = int(size[0]), int(size[1])
            ncols_per_entry = 2 if field == "complex" else 1
            vals = np.loadtxt(f, dtype=np.float64, ndmin=2)
            vals = vals.reshape(-1, ncols_per_entry)[:, 0]
            if symmetry == "general":
                dense = vals.reshape(n, m).T  # column-major storage
            else:
                # MM array symmetric/hermitian files store the lower
                # triangle including the diagonal; skew-symmetric files
                # store STRICTLY lower entries (the diagonal is implicitly
                # zero) — the triangle offset differs (mmio spec; the
                # reference's coordinate reader has the same asymmetry,
                # `mmio_highlevel.h:687-694`).
                # Array storage is column-major: column j lists rows
                # j..m-1 (symmetric/hermitian) or j+1..m-1 (skew). That
                # order equals a row-major walk of the UPPER triangle of
                # the transpose, so fill via triu_indices swapped.
                dense = np.zeros((m, n))
                k = 1 if symmetry == "skew-symmetric" else 0
                rows_u, cols_u = np.triu_indices(m, k)
                if vals.size != rows_u.size:
                    raise MatrixMarketError(
                        f"array {symmetry} file: expected {rows_u.size} "
                        f"entries, got {vals.size}")
                dense[cols_u, rows_u] = vals
                upper = dense.T.copy()
                if symmetry == "skew-symmetric":
                    upper = -upper
                np.fill_diagonal(upper, 0.0)
                dense = dense + upper
            return CSR.from_dense(dense.astype(dtype)), symmetry != "general"

        m, n, nnz_decl = int(size[0]), int(size[1]), int(size[2])
        body = f.read()

    # Vectorized parse of the coordinate block.
    ncols = 2 if field == "pattern" else (4 if field == "complex" else 3)
    raw = np.loadtxt(io.StringIO(body), dtype=np.float64, ndmin=2)
    if raw.size == 0:
        raw = raw.reshape(0, ncols)
    if raw.shape[0] != nnz_decl:
        raise MatrixMarketError(
            f"declared nnz {nnz_decl} != parsed rows {raw.shape[0]}"
        )
    if raw.shape[1] < ncols:
        raise MatrixMarketError(
            f"expected >= {ncols} columns for field {field!r}, got {raw.shape[1]}"
        )

    rows = raw[:, 0].astype(np.int64) - 1
    cols = raw[:, 1].astype(np.int64) - 1
    if field == "pattern":
        vals = np.ones(rows.size, dtype=np.float64)
    else:
        vals = raw[:, 2]

    if rows.size and (
        rows.min() < 0 or cols.min() < 0 or rows.max() >= m or cols.max() >= n
    ):
        raise MatrixMarketError("index out of declared bounds")

    is_symmetric = symmetry != "general"
    if is_symmetric and expand_symmetric:
        off = rows != cols
        mrows = np.concatenate([rows, cols[off]])
        mcols = np.concatenate([cols, rows[off]])
        mirror_vals = vals[off]
        if symmetry == "skew-symmetric":
            mirror_vals = -mirror_vals
        mvals = np.concatenate([vals, mirror_vals])
        rows, cols, vals = mrows, mcols, mvals

    csr = CSR.from_coo(rows, cols, vals.astype(dtype), (m, n))
    return csr, is_symmetric


def write_mtx(path: str | os.PathLike, csr: CSR, comment: str = "") -> None:
    """Write a CSR matrix in coordinate-real-general form (1-based)."""
    with open(os.fspath(path), "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{csr.m} {csr.n} {csr.nnz}\n")
        rows = csr.rows_expanded() + 1
        cols = csr.indices.astype(np.int64) + 1
        for r, c, v in zip(rows, cols, csr.data):
            f.write(f"{r} {c} {v:.17g}\n")
