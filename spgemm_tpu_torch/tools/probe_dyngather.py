"""Dynamic-gather probe on the card: the port's counterpart of the JAX
repo's `tools/probe_dyngather.py`, the blockwise take_along_axis that the
unstructured SpGEMM engine was designed around, through the hand kernel
that replaces its Pallas kernel (`ops/gather_kernels.py:take_along_blocks`,
`csrc/dyngather.cu`).

The reference's nine cases, with their shapes, blocks and index ranges:
lane gathers (axis 1, within a row) and sublane gathers (axis 0, within
a column of a block of blk rows). For each case:
  ok     the kernel's output equals the blockwise take (NumPy's
         take_along_axis on each block), the function the kernel
         computes; the reference compared axis 0 against the global take,
         which differs once R > blk;
  ms     chained_device_ms over LOOP dependent calls, each with the
         reference's x + acc*1e-30 add and 8-element sum around the
         gather, and the reference's G elem/s from it;
  device the kernel alone, torch.profiler's device time (the small cases
         sit below the host's launch overhead);
  bound  12 bytes per element (x, idx read, out written) over 3.35 TB/s;
  gather torch.gather on the blocked view (int64 indices, which it
         takes), CUDA events: the library yardstick, never used by the
         port.

Usage (from the repository root, on a machine with a card):
  python -m spgemm_tpu_torch.tools.probe_dyngather [--out PATH]

Results go to `data_h100/probe_dyngather.txt` (`--out`), the first line
the card's name and power limit. Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from spgemm_tpu_torch.ops.gather_kernels import take_along_blocks

LOOP = 20
OUT = os.path.join("data_h100", "probe_dyngather.txt")
BYTES_PER_ELEM = 12             # x (f32) and idx (int32) read, out written

# (name, shape, axis, blk_rows, idx_max): the reference's nine cases
CASES = (
    ("lane gather (8192,128) blk=512 idx<128", (8192, 128), 1, 512, 128),
    ("lane gather (8192,256) blk=512 idx<256", (8192, 256), 1, 512, 256),
    ("lane gather (8192,512) blk=512 idx<512", (8192, 512), 1, 512, 512),
    ("lane gather (8192,1024) blk=256 idx<1024", (8192, 1024), 1, 256, 1024),
    ("lane gather big (131072,128) blk=1024", (131072, 128), 1, 1024, 128),
    ("lane gather big (65536,256) blk=1024", (65536, 256), 1, 1024, 256),
    ("sublane gather (8192,128) blk=8 idx<8", (8192, 128), 0, 8, 8),
    ("sublane gather (8192,128) blk=32 idx<32", (8192, 128), 0, 32, 32),
    ("sublane gather (8192,128) blk=512 idx<512", (8192, 128), 0, 512, 512),
)


def make_gather_kernel(shape, axis, blk_rows):
    """fn(x, idx) = take_along_axis(x_blk, idx_blk, axis) on each block of
    blk_rows rows of an (R, C) float32 array: the hand kernel on CUDA
    tensors, its plain version on CPU tensors."""
    del shape  # the wrapper reads it from x

    def fn(x, idx):
        return take_along_blocks(x, idx, axis=axis, blk_rows=blk_rows)
    return fn


def blockwise_take(x, idx, axis, blk_rows):
    """NumPy's take_along_axis on each block of blk_rows rows."""
    r, c = x.shape
    shape = (r // blk_rows, blk_rows, c)
    return np.take_along_axis(x.reshape(shape), idx.reshape(shape),
                              axis=axis + 1).reshape(r, c)


def case_inputs(shape, idx_max):
    """The reference's inputs: default_rng(0), x uniform, idx < idx_max."""
    rng = np.random.default_rng(0)
    x = rng.random(shape, dtype=np.float32)
    return x, rng.integers(0, idx_max, shape).astype(np.int32)


def try_case(name, shape, axis, blk_rows, idx_max, out):
    """One case on the card: one line (ok, times) appended to `out`."""
    from spgemm_tpu_torch.utils.roofline import ChipSpec
    from spgemm_tpu_torch.utils.timing import (chained_device_ms,
                                               cuda_event_ms,
                                               profiler_device_ms)

    r, c = shape
    x, idx = case_inputs(shape, idx_max)
    xd = torch.from_numpy(x).to("cuda")
    id_ = torch.from_numpy(idx).to("cuda")
    try:
        fn = make_gather_kernel(shape, axis, blk_rows)
        got = fn(xd, id_).cpu().numpy()
        ok = np.array_equal(got, blockwise_take(x, idx, axis, blk_rows))

        def chain(x, i):
            acc = torch.zeros((), dtype=torch.float32, device=x.device)
            for _ in range(LOOP):
                acc = acc + fn(x + acc * 1e-30, i)[-1, -8:].sum()
            return acc

        ms = chained_device_ms(chain, xd, id_, loop=LOOP)
        dev_ms = profiler_device_ms(lambda: fn(xd, id_))
        bound_ms = ChipSpec.h100().bound(BYTES_PER_ELEM * r * c)[2]
        view = (r // blk_rows, blk_rows, c)
        xv, iv = xd.view(view), id_.long().view(view)
        gather_ms = cuda_event_ms(lambda: torch.gather(xv, axis + 1, iv))
        rate = r * c / (ms * 1e-3) / 1e9
        line = (f"{name:44s} ok={ok}  {ms:8.3f} ms  {rate:8.2f} G elem/s  "
                f"device {dev_ms:.4f} ms  bound {bound_ms:.4f} ms  "
                f"torch.gather {gather_ms:.4f} ms")
    except (RuntimeError, ValueError) as e:
        line = f"{name:44s} FAILED: {str(e).splitlines()[0][:90]}"
    print(line, flush=True)
    out.append(line)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_dyngather: no CUDA device (the probe times the card)",
              file=sys.stderr)
        return 1
    from spgemm_tpu_torch.utils.timing import card_line

    out = [card_line()]
    print(out[0], flush=True)
    for case in CASES:
        try_case(*case, out)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        fh.write("\n".join(out) + "\n")
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
