"""Checkpoint / resume: CSR and TileMat in .npz archives (port of
`spgemm_tpu/io/checkpoint.py`, the same format: one archive per matrix,
self-describing through its `kind` and `version` fields, so a file
written by either package loads in the other)."""

from __future__ import annotations

import os

import numpy as np

from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import TileMat

_FORMAT_VERSION = 1


def save_csr(path: str | os.PathLike, a: CSR) -> None:
    np.savez_compressed(
        path, kind="csr", version=_FORMAT_VERSION,
        shape=np.asarray(a.shape, np.int64),
        indptr=a.indptr, indices=a.indices, data=a.data,
    )


def save_tilemat(path: str | os.PathLike, t: TileMat) -> None:
    np.savez_compressed(
        path, kind="tilemat", version=_FORMAT_VERSION,
        shape=np.asarray(t.shape, np.int64),
        tm=np.int64(t.tm), tn=np.int64(t.tn),
        trow=t.trow, tcol=t.tcol, tptr=t.tptr, tnnz_ptr=t.tnnz_ptr,
        rc=t.rc, val=t.val, mask=t.mask, rowptr=t.rowptr,
    )


def load(path: str | os.PathLike) -> CSR | TileMat:
    """Load a checkpoint; dispatches on the archive's `kind` field."""
    with np.load(path, allow_pickle=False) as z:
        kind = str(z["kind"])
        version = int(z["version"])
        if version > _FORMAT_VERSION:
            raise ValueError(
                f"checkpoint {path} has version {version}; this build "
                f"reads <= {_FORMAT_VERSION}")
        if kind == "csr":
            return CSR(z["indptr"], z["indices"], z["data"],
                       tuple(int(x) for x in z["shape"]))
        if kind == "tilemat":
            return TileMat(
                shape=tuple(int(x) for x in z["shape"]),
                tm=int(z["tm"]), tn=int(z["tn"]),
                trow=z["trow"], tcol=z["tcol"], tptr=z["tptr"],
                tnnz_ptr=z["tnnz_ptr"], rc=z["rc"], val=z["val"],
                mask=z["mask"], rowptr=z["rowptr"],
            )
        raise ValueError(f"unknown checkpoint kind {kind!r} in {path}")


def save(path: str | os.PathLike, obj: CSR | TileMat) -> None:
    if isinstance(obj, CSR):
        save_csr(path, obj)
    elif isinstance(obj, TileMat):
        save_tilemat(path, obj)
    else:
        raise TypeError(f"cannot checkpoint {type(obj).__name__}")
