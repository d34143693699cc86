"""Sort, scan and gather rates on the card, each call depending on the
last: the port's counterpart of the JAX repo's `tools/probe_sort.py`.

The rows are the reference's nine, as eager torch ops at its F =
8,388,608: `lax.sort` is `torch.sort`, `sort_key_val` a sort and a
gather of the payload by the sort's indices (two payloads: one sort, two
gathers), the batched axis-1 sort `torch.sort(dim=1)`, `cumsum`
`torch.cumsum`, `take` indexing and `take_along_axis`
`torch.take_along_dim`. Every call's input depends on the scalar the
previous call left (`dep(acc)`, a runtime zero), as in the reference.
Sorts are stable, as `lax.sort`'s default.

After the nine rows at F, the three full-array sort rows run again at
F = 400,458,682, the product count of the rmat65536 A^2 (PERF.md §4):
what a device ESC symbolic would sort.

Usage (from the repository root, on a machine with a card):
  python -m spgemm_tpu_torch.tools.probe_sort [--out PATH]

Results go to `data_h100/probe_sort.txt` (`--out`), the first line the
card's name and power limit. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

LOOP = 10
F = 8 * 1024 * 1024
F_SYMBOLIC = 400_458_682        # rmat65536 A^2's products
F1 = 1024 * 1024                # the small sort
SEG = 2048                      # batched sort and take_along_axis rows
TAB_SMALL = 16384               # the small gather table
OUT = os.path.join("data_h100", "probe_sort.txt")


def report(name, ms, elems, out, width=40):
    rate = elems / (ms * 1e-3) / 1e9 if ms > 0 else float("inf")
    line = f"{name:{width}s} {ms:9.3f} ms   {rate:8.2f} G elem/s"
    print(line, flush=True)
    out.append(line)


def dep(acc):
    """A runtime zero (int32) from the loop-carried scalar: nothing can
    be hoisted out of the chain."""
    return (acc > 1e30).to(torch.int32)


def chained(op, reduce, loop):
    """chain(*args): `loop` calls of op(acc, *args), each fed the scalar
    acc that the previous calls summed (reduce of op's result, f32)."""
    def chain(*args):
        acc = torch.zeros((), dtype=torch.float32, device=args[0].device)
        for _ in range(loop):
            acc = acc + reduce(op(acc, *args)).to(torch.float32)
        return acc
    return chain


# --- the rows: op (the work timed) and reduce (the reference's scalar) -----

def sort_keys(acc, k):
    return torch.sort(k + dep(acc), stable=True).values


def sort_key_val(acc, k, v):
    s = torch.sort(k + dep(acc), stable=True)
    return s.values, v[s.indices]


def sort_key_2payloads(acc, k, v):
    s = torch.sort(k + dep(acc), stable=True)
    return s.values, v[s.indices], (v * 2.0)[s.indices]


def batched_sort(acc, kb):
    return torch.sort(kb + dep(acc), dim=1, stable=True).values


def cumsum(acc, v):
    return torch.cumsum(v + acc * 1e-30, 0)


def element_gather(acc, t, ix):
    return (t + acc * 1e-30)[ix]


def take_rows(acc, v, ix):
    return torch.take_along_dim(v + acc * 1e-30, ix, dim=1)


def last8(x):
    return x[-8:].sum()


def payload_last8(res):
    return res[1][-8:].sum()


# name -> (op, reduce, input names, elements per call)
ROWS = {
    "sort int32 (real dep)": (sort_keys, last8, ("keys",), "f"),
    "sort_key_val int32/f32 (real dep)": (sort_key_val, payload_last8,
                                          ("keys", "vals"), "f"),
    "sort key + 2 payloads": (sort_key_2payloads, payload_last8,
                              ("keys", "vals"), "f"),
    "sort int32 1M (real dep)": (sort_keys, last8, ("keys_1m",), "f1"),
    "batched sort 4096x2048 axis=1": (batched_sort, lambda x: x[:, -1].sum(),
                                      ("keys_rows",), "f"),
    "cumsum f32 (recheck)": (cumsum, lambda x: x[-1], ("vals",), "f"),
    "element gather small table 16K": (element_gather, torch.sum,
                                       ("tab_small", "idx_small"), "f"),
    "take_along_axis rows of 2048": (take_rows, lambda x: x[:, -1].sum(),
                                     ("vals_rows", "idx_rows"), "f"),
    "row gather 8-wide": (element_gather, torch.sum, ("tab8", "idx8"), "f"),
}
SORT_ROWS = ("sort int32 (real dep)", "sort_key_val int32/f32 (real dep)",
             "sort key + 2 payloads")


def make_inputs(f: int, names, device) -> dict:
    """The rows' inputs at F = f, each from its own seeded generator (so
    a subset of rows draws the same data), uploaded to `device`."""
    def rng(i):
        return np.random.default_rng([0, i])

    def build(name):
        if name == "keys":
            return rng(0).integers(0, 1 << 30, f, dtype=np.int32)
        if name == "vals":
            return rng(1).random(f, dtype=np.float32)
        if name == "keys_1m":
            return build("keys")[:F1]
        if name == "keys_rows":
            return build("keys").reshape(f // SEG, SEG)
        if name == "tab_small":
            return build("vals")[:TAB_SMALL]
        if name == "idx_small":
            return rng(2).integers(0, min(f, TAB_SMALL), f, dtype=np.int32)
        if name == "vals_rows":
            return build("vals").reshape(f // SEG, SEG)
        if name == "idx_rows":
            return rng(3).integers(0, SEG, f, dtype=np.int64).reshape(
                f // SEG, SEG)
        if name == "tab8":
            return build("vals")[: 2 * 1024 * 1024].reshape(-1, 8)
        if name == "idx8":
            return rng(4).integers(0, min(f, 2 * 1024 * 1024) // 8, f // 8,
                                   dtype=np.int32)
        raise KeyError(name)

    return {n: torch.from_numpy(np.ascontiguousarray(build(n))).to(device)
            for n in names}


def run(f: int = F, out=None, rows=tuple(ROWS)) -> list:
    """Times `rows` at F = f on the card with chained_device_ms (LOOP
    dependent calls, best of 3); appends one line per row to `out` and
    returns it."""
    from spgemm_tpu_torch.utils.timing import chained_device_ms

    out = [] if out is None else out
    names = sorted({n for r in rows for n in ROWS[r][2]})
    data = make_inputs(f, names, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in rows:
        op, reduce, args, elems = ROWS[name]
        ms = chained_device_ms(chained(op, reduce, LOOP),
                               *[data[a] for a in args], loop=LOOP)
        report(name, ms, F1 if elems == "f1" else f, out)
    line = (f"peak device memory {torch.cuda.max_memory_allocated()} bytes "
            f"(inputs {sum(t.numel() * t.element_size() for t in data.values())})")
    print(line, flush=True)
    out.append(line)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_sort: no CUDA device (the probe times the card)",
              file=sys.stderr)
        return 1
    from spgemm_tpu_torch.utils.timing import card_line

    out = [card_line(), f"F={F} LOOP={LOOP} (ms: chained_device_ms, best "
                        f"of 3 chains of LOOP dependent calls, / LOOP)"]
    for line in out:
        print(line, flush=True)
    run(F, out)
    line = (f"F={F_SYMBOLIC} (the rmat65536 A^2's products: what a device "
            f"ESC symbolic sorts)")
    print(line, flush=True)
    out.append(line)
    run(F_SYMBOLIC, out, SORT_ROWS)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write("\n".join(out) + "\n")
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
