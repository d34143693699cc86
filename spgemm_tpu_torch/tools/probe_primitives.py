"""Rates of the primitives an unstructured SpGEMM engine could be built
from, on the card: the port's counterpart of the JAX repo's
`tools/probe_primitives.py` (element and row gather, sort, segment sum,
cumsum, masked-matmul segment reduce, one-hot matmul gather).

The rows are the reference's nine at its F, TAB, ROWS and RW, as eager
torch ops: `take` is indexing, `segment_sum` `index_add_` (sorted and
unsorted ids), and the two matmul rows `torch.bmm` on bf16 operands with
float32 output, their one-hot operands built in chunks of groups (the
one-hot gather's operand would be 34 GB at once; the reference's XLA
fuses it away). Every call's input depends on the scalar the previous
call left, as in the reference.

The sort rows sort for real here. The reference perturbed their keys
with `acc*0`, which XLA folds, and then hoisted the sort out of its
chain (the JAX `tools/probe_sort.py` says so), so its TPU sort rows time
no sort; eager torch folds nothing.

Usage (from the repository root, on a machine with a card):
  python -m spgemm_tpu_torch.tools.probe_primitives [--out PATH]

Results go to `data_h100/probe_primitives.txt` (`--out`), the first line
the card's name and power limit. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from spgemm_tpu_torch.tools.probe_sort import chained, last8, report

LOOP = 20
F = 8 * 1024 * 1024          # product-stream length (~random8192 flops)
TAB = 2 * 1024 * 1024        # value-table length (~nnz)
ROWS = 65536                 # row-gather table height
RW = 128                     # row width
W = 512                      # masked-matmul group width
SEGS = 128                   # masked-matmul outputs per group
BW = 2048                    # one-hot gather window
ONEHOT_BYTES = 1 << 30       # bf16 one-hot operand per bmm chunk
OUT = os.path.join("data_h100", "probe_primitives.txt")


def bmm_f32(a, b):
    """a @ b batched, bf16 operands, float32 output. On the card one
    bf16 tensor-core bmm with f32 output; on the CPU the same products
    (exact in f32) summed in f32."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _group_chunks(groups: int, bytes_per_group: int):
    step = max(1, ONEHOT_BYTES // bytes_per_group)
    for g0 in range(0, groups, step):
        yield g0, min(groups, g0 + step)


# --- the rows: op (the work timed) and reduce (the reference's scalar) -----

def element_gather(acc, t, ix):
    return (t + acc * 1e-30)[ix]


def sort_keys(acc, k):
    return torch.sort(k + acc.to(torch.int32) * 0, stable=True).values


def sort_key_val(acc, k, v):
    s = torch.sort(k + acc.to(torch.int32) * 0, stable=True)
    return s.values, v[s.indices]


def segment_sum(acc, v, s):
    out = torch.zeros(v.numel() // 2, dtype=torch.float32, device=v.device)
    return out.index_add_(0, s, v + acc * 1e-30)


def cumsum(acc, v):
    return torch.cumsum(v + acc * 1e-30, 0)


def masked_seg_reduce(acc, p, s):
    """outs[g, o] = sum of p[g, w] over the w with s[g, w] == o: the
    group's (W, SEGS) 0/1 membership mask contracted in bf16."""
    pb = (p + acc * 1e-30).to(torch.bfloat16)
    oid = torch.arange(SEGS, device=p.device, dtype=s.dtype)
    out = torch.empty(p.shape[0], SEGS, dtype=torch.float32, device=p.device)
    for g0, g1 in _group_chunks(p.shape[0], p.shape[1] * SEGS * 2):
        mask = (s[g0:g1, :, None] == oid).to(torch.bfloat16)
        out[g0:g1] = bmm_f32(pb[g0:g1, None, :], mask)[:, 0]
    return out


def onehot_gather(acc, v, ix):
    """res[g, d] = v[g, ix[g, d]] as a bf16 product with the (BW, BW)
    one-hot oh[g, s, d] = (ix[g, d] == s)."""
    vb = (v + acc * 1e-30).to(torch.bfloat16)
    bw = v.shape[1]
    src = torch.arange(bw, device=v.device, dtype=ix.dtype)[:, None]
    out = torch.empty(v.shape, dtype=torch.float32, device=v.device)
    for g0, g1 in _group_chunks(v.shape[0], bw * bw * 2):
        oh = (ix[g0:g1, None, :] == src).to(torch.bfloat16)
        out[g0:g1] = bmm_f32(vb[g0:g1, None, :], oh)[:, 0]
    return out


def payload_last8(res):
    return res[1][-8:].sum()


def cols_last8(x):
    return x[:, -8:].sum()


# name -> (op, reduce, input names)
PROBES = {
    "element gather (take)": (element_gather, torch.sum, ("table", "idx")),
    "row gather (take axis=0, 128w)": (element_gather, torch.sum,
                                       ("rowtab", "ridx")),
    "sort int32 keys": (sort_keys, last8, ("keys",)),
    "sort_key_val int32/f32": (sort_key_val, payload_last8,
                               ("keys", "vals")),
    "segment_sum sorted ids": (segment_sum, last8, ("vals", "seg_sorted")),
    "segment_sum unsorted ids": (segment_sum, last8, ("vals", "seg_unsorted")),
    "cumsum f32": (cumsum, lambda x: x[-1], ("vals",)),
    f"masked-matmul seg reduce W={W}": (masked_seg_reduce, cols_last8,
                                        ("pmat", "sid")),
    f"one-hot matmul gather BW={BW}": (onehot_gather, cols_last8,
                                       ("vblk", "lidx")),
}


def make_inputs(f: int, device) -> dict:
    """Every row's inputs at product-stream length f (the reference's
    shapes at f = F; the tests run smaller), from default_rng(0)."""
    rng = np.random.default_rng(0)
    tab, rows = min(TAB, f // 4), min(ROWS, max(1, f // RW))
    idx = rng.integers(0, tab, f, dtype=np.int32)
    d = dict(
        table=rng.random(tab, dtype=np.float32), idx=idx,
        rowtab=rng.random((rows, RW), dtype=np.float32),
        ridx=rng.integers(0, rows, f // RW, dtype=np.int32),
        keys=rng.integers(0, 1 << 30, f, dtype=np.int32),
        vals=rng.random(f, dtype=np.float32),
        seg_sorted=np.sort(rng.integers(0, f // 2, f, dtype=np.int32)),
        seg_unsorted=idx // 2,
        pmat=rng.random((f // W, W), dtype=np.float32),
        sid=np.sort(rng.integers(0, SEGS, (f // W, W), dtype=np.int32),
                    axis=1),
        lidx=rng.integers(0, BW, f, dtype=np.int32).reshape(f // BW, BW),
        vblk=rng.random((f // BW, BW), dtype=np.float32))
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in d.items()}


def run(out=None) -> list:
    """Times every row at the reference's sizes on the card with
    chained_device_ms (LOOP dependent calls, best of 3); appends one line
    per row to `out` and returns it."""
    from spgemm_tpu_torch.utils.timing import chained_device_ms

    out = [] if out is None else out
    data = make_inputs(F, "cuda")
    torch.cuda.synchronize()
    for name, (op, reduce, args) in PROBES.items():
        ms = chained_device_ms(chained(op, reduce, LOOP),
                               *[data[a] for a in args], loop=LOOP)
        report(name, ms, F, out, width=34)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_primitives: no CUDA device (the probe times the card)",
              file=sys.stderr)
        return 1
    from spgemm_tpu_torch.utils.timing import card_line

    out = [card_line(),
           f"F={F} TAB={TAB} LOOP={LOOP} (ms: chained_device_ms, best of 3 "
           f"chains of LOOP dependent calls, / LOOP); the sort rows sort "
           f"for real (eager torch does not fold the reference's acc*0)"]
    for line in out:
        print(line, flush=True)
    run(out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write("\n".join(out) + "\n")
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
