"""Golden-model SpGEMM oracles on the host, exact in f64 (port of
`spgemm_tpu/ops/golden.py`). NumPy and scipy only.

* `spgemm_spa_bitflag` — bit-flag sparse-accumulator symbolic pass: one
  uint32 flag word per 32 columns, bit-scan for sorted column emission.
* `spgemm_dense_row`   — dense-row accumulator numeric SpGEMM.
* `spgemm_esc`         — expand / sort / compress.
* `spgemm_scipy`       — the scipy.sparse product (the cuSPARSE analogue).
* `rows_match_oracle`  — a row-sample check for runs too large for the
  full oracle.

The first three keep C's explicit zeros (an entry is structural if any
a_ik * b_kj term exists, even when the sum cancels); scipy prunes them,
so compare against it through `drop_explicit_zeros`.
"""

from __future__ import annotations

import numpy as np

from spgemm_tpu_torch.models.csr import CSR, INDEX_DTYPE


def _check_dims(a: CSR, b: CSR) -> None:
    if a.n != b.m:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")


def _expand_products(a: CSR, b: CSR, lo: int, hi: int):
    """All partial products of A rows [lo, hi): (local_rows, cols, vals)
    arrays with one entry per product."""
    alo, ahi = int(a.indptr[lo]), int(a.indptr[hi])
    ks = a.indices[alo:ahi]
    counts = (b.indptr[ks + 1] - b.indptr[ks]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        e = np.zeros(0, np.int64)
        return e, e, np.zeros(0)
    arow = np.repeat(
        np.arange(lo, hi, dtype=np.int64),
        (a.indptr[lo + 1 : hi + 1] - a.indptr[lo:hi]).astype(np.int64),
    ) - lo
    rows = np.repeat(arow, counts)
    reps = np.repeat(b.indptr[ks].astype(np.int64), counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    bpos = reps + offs
    cols = b.indices[bpos].astype(np.int64)
    vals = np.repeat(a.data[alo:ahi], counts) * b.data[bpos]
    return rows, cols, vals


def _row_blocks(a: CSR, b: CSR, budget: int = 1 << 23):
    """Row-block boundaries keeping each block's expanded products under
    `budget` elements (at least one row per block)."""
    blen = (b.indptr[1:] - b.indptr[:-1]).astype(np.int64)
    per_row = (np.bincount(a.rows_expanded(), weights=blen[a.indices],
                           minlength=a.m).astype(np.int64)
               if a.nnz else np.zeros(a.m, np.int64))
    fl = np.zeros(a.m + 1, dtype=np.int64)
    np.cumsum(per_row, out=fl[1:])
    bounds = [0]
    while bounds[-1] < a.m:
        lo = bounds[-1]
        hi = int(np.searchsorted(fl, fl[lo] + budget, side="right")) - 1
        bounds.append(min(max(hi, lo + 1), a.m))
    return bounds


def spgemm_spa_bitflag(a: CSR, b: CSR) -> CSR:
    """Bit-flag SPA: the pattern through 32-wide uint32 flag words
    (OR-reduce of column bits per (row, word)), emitted by bit-scan in
    ascending column order; values by a segment sum over the sorted
    expansion. Vectorized over row blocks."""
    _check_dims(a, b)
    m, n = a.m, b.n
    nwords = n // 32 + 1
    indptr = np.zeros(m + 1, dtype=INDEX_DTYPE)
    out_cols: list[np.ndarray] = []
    out_vals: list[np.ndarray] = []
    bounds = _row_blocks(a, b)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows, cols, vals = _expand_products(a, b, lo, hi)
        nb = hi - lo
        counts = np.zeros(nb, np.int64)
        if rows.size:
            # flag words: sort by (row, word), OR-reduce runs
            wkey = rows * nwords + (cols >> 5)
            order = np.argsort(wkey, kind="stable")
            wkey_s = wkey[order]
            bits = (np.uint32(1) << (cols[order] & 31).astype(np.uint32))
            starts = np.flatnonzero(
                np.concatenate(([True], wkey_s[1:] != wkey_s[:-1])))
            words = np.bitwise_or.reduceat(bits, starts)
            # set bits of each word in ascending column order
            shifts = np.arange(32, dtype=np.uint32)
            expanded = ((words[:, None] >> shifts) & 1).astype(bool)
            wrow = wkey_s[starts] // nwords
            wcol0 = (wkey_s[starts] % nwords) * 32
            sel = expanded.nonzero()
            cols_blk = wcol0[sel[0]] + sel[1]
            rows_blk = wrow[sel[0]]
            keep = cols_blk < n
            cols_blk, rows_blk = cols_blk[keep], rows_blk[keep]
            # values: segment sums over the (row, col) sorted order
            vkey = rows * np.int64(n) + cols
            vorder = np.argsort(vkey, kind="stable")
            vkey_s = vkey[vorder]
            vstarts = np.flatnonzero(
                np.concatenate(([True], vkey_s[1:] != vkey_s[:-1])))
            vals_blk = np.add.reduceat(vals[vorder], vstarts)
            counts = np.bincount(rows_blk, minlength=nb)
            out_cols.append(cols_blk.astype(INDEX_DTYPE))
            out_vals.append(vals_blk)
        indptr[lo + 1 : hi + 1] = indptr[lo] + np.cumsum(counts)
    indices = (np.concatenate(out_cols) if out_cols
               else np.zeros(0, INDEX_DTYPE))
    data = np.concatenate(out_vals) if out_vals else np.zeros(0)
    return CSR(indptr, indices, data, (m, n))


def spgemm_dense_row(a: CSR, b: CSR) -> CSR:
    """Dense-row accumulator: a dense value array and a structural flag
    array per row block, each filled by one histogram pass (np.bincount
    over row*n+col keys)."""
    _check_dims(a, b)
    m, n = a.m, b.n
    indptr = np.zeros(m + 1, dtype=INDEX_DTYPE)
    out_cols: list[np.ndarray] = []
    out_vals: list[np.ndarray] = []
    # cap the dense accumulator (block*n doubles) at ~64 MB
    row_cap = max(1, (1 << 23) // max(n, 1))
    bounds = _row_blocks(a, b)
    bounds = sorted({bb for lo, hi in zip(bounds[:-1], bounds[1:])
                     for bb in range(lo, hi + 1, row_cap)} | {0, m})
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        rows, cols, vals = _expand_products(a, b, lo, hi)
        nb = hi - lo
        counts = np.zeros(nb, np.int64)
        if rows.size:
            keys = rows * np.int64(n) + cols
            width = nb * n
            acc = np.bincount(keys, weights=vals, minlength=width)
            flag = np.bincount(keys, minlength=width).astype(bool)
            hit = np.flatnonzero(flag)
            rows_blk = hit // n
            out_cols.append((hit % n).astype(INDEX_DTYPE))
            out_vals.append(acc[hit])
            counts = np.bincount(rows_blk, minlength=nb)
        indptr[lo + 1 : hi + 1] = indptr[lo] + np.cumsum(counts)
    indices = (np.concatenate(out_cols) if out_cols
               else np.zeros(0, INDEX_DTYPE))
    data = np.concatenate(out_vals) if out_vals else np.zeros(0)
    return CSR(indptr, indices, data, (m, n))


def spgemm_esc(a: CSR, b: CSR) -> CSR:
    """Expand-sort-compress: expand every partial product, sort by (row,
    col), sum equal keys."""
    _check_dims(a, b)
    m, n = a.m, b.n
    blen = (b.indptr[1:] - b.indptr[:-1]).astype(np.int64)
    counts = blen[a.indices]  # products contributed per A nonzero
    total = int(counts.sum())
    if total == 0:
        return CSR(np.zeros(m + 1, INDEX_DTYPE), np.zeros(0, INDEX_DTYPE),
                   np.zeros(0), (m, n))
    rows = np.repeat(a.rows_expanded(), counts)
    reps = np.repeat(b.indptr[a.indices].astype(np.int64), counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts)
    bpos = reps + offs
    cols = b.indices[bpos].astype(np.int64)
    vals = np.repeat(a.data, counts) * b.data[bpos]
    key = rows * n + cols
    order = np.argsort(key, kind="stable")
    key, vals = key[order], vals[order]
    uniq = np.empty(total, dtype=bool)
    uniq[0] = True
    np.not_equal(key[1:], key[:-1], out=uniq[1:])
    seg = np.cumsum(uniq) - 1
    out_vals = np.zeros(int(seg[-1]) + 1)
    np.add.at(out_vals, seg, vals)
    ukey = key[uniq]
    indptr = np.zeros(m + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(ukey // n, minlength=m), out=indptr[1:])
    return CSR(indptr, (ukey % n).astype(INDEX_DTYPE), out_vals, (m, n))


def spgemm_scipy(a: CSR, b: CSR) -> CSR:
    """scipy.sparse oracle (the cuSPARSE analogue). scipy prunes explicit
    zeros in C, so compare tiled results through drop_explicit_zeros."""
    import scipy.sparse as sp

    _check_dims(a, b)
    sa = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    sb = sp.csr_matrix((b.data, b.indices, b.indptr), shape=b.shape)
    sc = (sa @ sb).tocsr()
    sc.sort_indices()
    return CSR(
        sc.indptr.astype(INDEX_DTYPE),
        sc.indices.astype(INDEX_DTYPE),
        sc.data.astype(np.float64),
        sc.shape,
    )


def drop_explicit_zeros(c: CSR) -> CSR:
    """Drop stored zeros, for comparing against zero-pruning oracles."""
    keep = c.data != 0.0
    rows = c.rows_expanded()[keep]
    indptr = np.zeros(c.m + 1, dtype=INDEX_DTYPE)
    np.cumsum(np.bincount(rows, minlength=c.m), out=indptr[1:])
    return CSR(indptr, c.indices[keep], c.data[keep], c.shape)


def rows_match_oracle(c: CSR, a: CSR, b: CSR, rows, *, rtol=1e-5,
                      atol=1e-6) -> bool:
    """Row-sample check for runs too large for the full oracle: the
    selected rows of A @ B through scipy on A's row slice, compared with
    the same rows of C in pattern and values after dropping explicit
    zeros on both sides."""
    import scipy.sparse as sp

    rows = np.asarray(rows, dtype=np.int64)

    def canon(mat):
        mat = mat.tocsr()
        mat.eliminate_zeros()
        mat.sort_indices()
        return mat

    sa = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)[rows]
    sb = sp.csr_matrix((b.data, b.indices, b.indptr), shape=b.shape)
    ref = canon(sa @ sb)
    got = canon(
        sp.csr_matrix((c.data, c.indices, c.indptr), shape=c.shape)[rows])
    return (np.array_equal(got.indptr, ref.indptr)
            and np.array_equal(got.indices, ref.indices)
            and np.allclose(got.data, ref.data, rtol=rtol, atol=atol))
