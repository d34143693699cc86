"""The plain reference: C = A @ B in PyTorch tensor operations, from the
raw CSR arrays the harness hands to the program.

It imports nothing of the program. C is the structural product: every
(i, j) that some stored A(i, k) and B(k, j) reach is an entry of C, as
a CSR with column indices sorted within each row. Each value is summed
in `acc` (float64 for the reference; float32 for the control), and so is
the sum of the products' magnitudes, |A||B|, against which an error is
scaled. Rows are taken in blocks of at most `max_products` products, so
the reference fits beside nothing else on the card.

`lower=True` rounds every input value one precision step below its
own before it is multiplied: float32 to TF32 (10 explicit significand
bits, to nearest even), float64 to float32. With float32 sums that is
the control, the precision one step below the configuration's.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_PRODUCTS = 1 << 25


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32, to nearest even (finite inputs)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _values(data: np.ndarray, device, acc: torch.dtype,
            lower: bool) -> torch.Tensor:
    v = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    if lower:
        v = round_tf32(v) if v.dtype == torch.float32 else v.float()
    return v.to(acc)


def _row_blocks(work: np.ndarray, limit: int) -> list[tuple[int, int]]:
    """[r0, r1) row ranges whose summed work stays under `limit` (a row
    heavier than that goes alone)."""
    blocks, r0, m = [], 0, work.size
    csum = np.concatenate([[0], np.cumsum(work, dtype=np.int64)])
    while r0 < m:
        r1 = int(np.searchsorted(csum, csum[r0] + limit, side="right")) - 1
        r1 = min(m, max(r1, r0 + 1))
        blocks.append((r0, r1))
        r0 = r1
    return blocks


def spgemm(a_indptr, a_indices, a_data, b_indptr, b_indices, b_data,
           n_cols: int, *, device, acc: torch.dtype = torch.float64,
           lower: bool = False, max_products: int = MAX_PRODUCTS):
    """C = A @ B. Returns (indptr, indices, values, magnitudes) as int64,
    int64, `acc` and `acc` tensors on `device`."""
    a_indptr = np.asarray(a_indptr, np.int64)
    b_indptr64 = np.asarray(b_indptr, np.int64)
    m = a_indptr.size - 1
    blen = np.diff(b_indptr64)
    csum = np.concatenate(
        [[0], np.cumsum(blen[np.asarray(a_indices, np.int64)])])
    row_work = csum[a_indptr[1:]] - csum[a_indptr[:-1]]

    dev = torch.device(device)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    ai = t(np.asarray(a_indices, np.int64))
    bi = t(np.asarray(b_indices, np.int64))
    bp = t(b_indptr64)
    bl = t(blen)
    av = _values(a_data, dev, acc, lower)
    bv = _values(b_data, dev, acc, lower)

    counts = torch.zeros(m, dtype=torch.int64, device=dev)
    cols, vals, mags = [], [], []
    for r0, r1 in _row_blocks(row_work, max_products):
        p0, p1 = int(a_indptr[r0]), int(a_indptr[r1])
        if p1 == p0:
            continue
        rows = torch.repeat_interleave(
            torch.arange(r0, r1, device=dev),
            t(np.diff(a_indptr[r0:r1 + 1])))
        k = ai[p0:p1]
        cnt = bl[k]
        total = int(cnt.sum())
        if total == 0:
            continue
        rep = torch.repeat_interleave(torch.arange(p1 - p0, device=dev), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        bpos = bp[k][rep] + (torch.arange(total, device=dev) - start[rep])
        key = (rows[rep] - r0) * n_cols + bi[bpos]
        prod = av[p0:p1][rep] * bv[bpos]
        del rep, bpos, start
        uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
        del key
        s = torch.zeros(uniq.numel(), dtype=acc, device=dev)
        s.index_add_(0, inv, prod)
        g = torch.zeros(uniq.numel(), dtype=acc, device=dev)
        g.index_add_(0, inv, prod.abs())
        del inv, prod
        crow = uniq // n_cols + r0
        counts += torch.bincount(crow, minlength=m)
        cols.append(uniq % n_cols)
        vals.append(s)
        mags.append(g)
    indptr = torch.zeros(m + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(counts, 0)
    empty = lambda dt: torch.zeros(0, dtype=dt, device=dev)
    cat = lambda xs, dt: torch.cat(xs) if xs else empty(dt)
    return (indptr, cat(cols, torch.int64), cat(vals, acc), cat(mags, acc))

