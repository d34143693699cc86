"""Numeric phase of the pair backends (port of `spgemm_tpu/ops/numeric.py`):
batched tile-pair products as torch ops, the backend="xla" route.

Every matched tile pair is one small dense product. The pipeline gathers
dense A/B tiles by pair index, multiplies them by `bmm` and
`index_add_`s the products into per-C-tile accumulators, values and
structural counts in the same pass:

    Cval[seg]  += Aden[pa] @ Bden[pb]          (numeric)
    Ccnt[seg]  += Aocc[pa] @ Bocc[pb]          (structural)

The counts are read only as > 0, so C's pattern is exact even where sums
cancel. Values accumulate in the operands' dtype (float32 or float64);
counts in float32. acc_dtype changes the value accumulator, as the JAX
package's preferred_element_type does; f32 products run in full FP32,
never TF32 (the JAX package's Precision.HIGHEST).
"""

from __future__ import annotations

import numpy as np
import torch

from spgemm_tpu_torch.ops.gustavson import full_fp32, product_dtype


def _pair_matmuls(a_val, a_occ, b_val, b_occ):
    """Batched per-pair products: values and structural counts (in
    float32, whatever the occupancy planes' dtype)."""
    return torch.bmm(a_val, b_val), torch.bmm(a_occ.float(), b_occ.float())


def pair_accumulate(a_val, a_occ, b_val, b_occ, pa, pb, seg, *,
                    num_segments: int, chunk: int = 32768, acc_dtype=None):
    """Returns (c_val, c_cnt), each (num_segments, tm, tn): c_val in
    acc_dtype (None: a_val's dtype), c_cnt float32.

    a_val (ntA, tm, tk) and b_val (ntB, tk, tn) are dense tiles, a_occ and
    b_occ their 0/1 occupancy (float32 or bfloat16: the counts are summed
    in float32 either way); pa, pb, seg (P,) the pair list
    sorted by segment (padding pairs may point at segment num_segments,
    which is dropped). Pairs are taken `chunk` at a time, so gathered
    tiles never exceed chunk * tile bytes."""
    tm = a_val.shape[1]
    tn = b_val.shape[2]
    dev = a_val.device
    acc = acc_dtype or a_val.dtype
    mm = product_dtype(a_val.dtype, acc)
    a_val, b_val = a_val.to(mm), b_val.to(mm)
    c_val = torch.zeros(num_segments + 1, tm, tn, dtype=acc, device=dev)
    c_cnt = torch.zeros(num_segments + 1, tm, tn, dtype=torch.float32,
                        device=dev)
    for lo in range(0, pa.shape[0], chunk):
        pac = pa[lo : lo + chunk].long()
        pbc = pb[lo : lo + chunk].long()
        segc = seg[lo : lo + chunk].long()
        with full_fp32():
            prod, cnt = _pair_matmuls(a_val[pac], a_occ[pac], b_val[pbc],
                                      b_occ[pbc])
        c_val.index_add_(0, segc, prod.to(acc))
        c_cnt.index_add_(0, segc, cnt)
    return c_val[:-1], c_cnt[:-1]


def pad_pairs(
    pa: np.ndarray, pb: np.ndarray, seg: np.ndarray, num_segments: int,
    chunk: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad pair arrays to a chunk multiple; padding pairs point at tile 0
    and the dummy segment `num_segments` (dropped by pair_accumulate)."""
    p = pa.size
    if p <= chunk or p % chunk == 0:
        return pa, pb, seg  # single-shot path / already aligned
    padn = -(-p // chunk) * chunk - p
    pad32 = lambda x, v: np.concatenate([x, np.full(padn, v, dtype=np.int32)])
    return pad32(pa, 0), pad32(pb, 0), pad32(seg, num_segments)
