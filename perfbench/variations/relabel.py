"""A fresh random relabelling (P A P^T) of the pattern each call, with
the seed's own values carried along: the same work each call, in another
order, and never the same pattern twice."""

import numpy as np
import torch

from perfbench.traffic import Inputs


def inputs(tr, call: int) -> Inputs:
    b = tr.base
    n = b.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(b.indptr))
    perm = torch.randperm(n, generator=tr.generator("relabel", call))
    perm = perm.numpy().astype(np.int64)
    key = perm[rows] * n + perm[b.indices]
    order = np.argsort(key, kind="stable")
    key = key[order]
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(key // n, minlength=n), out=indptr[1:])
    return Inputs(indptr, (key % n).astype(np.int32), b.data[order], b.shape)
