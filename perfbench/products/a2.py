"""C = A^2: its useful flops and minimal bytes, and the comparison of a
program's C with the plain reference's.

Numbers compared:
  pattern_mismatches  entries in one C and not in the other, repeated
                      entries, and (where the sets agree) entries out of
                      the reference's sorted order; exact, limit 0
  max_scaled_err      max over the entries of |C - C_ref| / (|A||A|)_ij,
                      the error in units of the entry's magnitude sum;
                      a non-finite value reads inf
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import reference, yardstick

TINY = float(np.finfo(np.float64).tiny)


def useful_flops(inp) -> float:
    return 2.0 * yardstick.nnz_cub(inp.indptr, inp.indices, inp.indptr)


def min_bytes(inp, ref, value_bytes: int) -> float:
    return float(yardstick.spgemm_min_bytes(
        inp.shape[0], inp.nnz, int(ref[1].numel()), value_bytes))


def reference_of(inp, device, *, control: bool = False):
    """The reference's C (float64), or the control's (inputs one
    precision step down, float32 sums)."""
    return reference.spgemm(
        inp.indptr, inp.indices, inp.data, inp.indptr, inp.indices, inp.data,
        inp.shape[1], device=device,
        acc=torch.float32 if control else torch.float64, lower=control)


def control_answer(ref):
    """A reference C in the form a program returns it (host CSR)."""
    indptr, indices, vals, _ = ref
    return (indptr.cpu().numpy(), indices.cpu().numpy(),
            vals.double().cpu().numpy())


def _keys(indptr: torch.Tensor, indices: torch.Tensor, n: int):
    m = indptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(m, device=indptr.device),
                                   torch.diff(indptr))
    return rows * n + indices


def compare(answer, ref, inp, device) -> dict[str, float]:
    dev = torch.device(device)
    t = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)
    indptr, indices, data = answer
    n = inp.shape[1]
    r_indptr, r_idx, r_val, r_mag = ref
    if indptr.size != r_indptr.numel():
        return {"pattern_mismatches": float(max(indices.size, 1)),
                "max_scaled_err": float("inf")}
    kp = _keys(t(indptr, torch.int64), t(indices, torch.int64), n)
    kr = _keys(r_indptr, r_idx, n)
    vp = t(data, torch.float64)
    if kp.numel() == kr.numel() and torch.equal(kp, kr):
        mism = 0
        vr, mr = r_val.double(), r_mag.double()
    else:
        mism = int((~torch.isin(kp, kr)).sum() + (~torch.isin(kr, kp)).sum()
                   + (kp.numel() - torch.unique(kp).numel()))
        if mism == 0:
            mism = int(kp.numel())  # the same entries in another order
        pos = torch.searchsorted(kr, kp).clamp(max=max(kr.numel() - 1, 0))
        hit = kr[pos] == kp if kr.numel() else torch.zeros_like(kp, dtype=bool)
        vp, vr, mr = vp[hit], r_val.double()[pos[hit]], r_mag.double()[pos[hit]]
    err = (vp - vr).abs() / mr.clamp(min=TINY)
    err = torch.nan_to_num(err, nan=float("inf"))
    worst = float(err.max()) if err.numel() else 0.0
    return {"pattern_mismatches": float(mism), "max_scaled_err": worst}
