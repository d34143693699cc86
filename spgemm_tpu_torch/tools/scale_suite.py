"""Multi-card scaling table of the PyTorch/CUDA port (counterpart of the
JAX package's `tools/scale_suite.py`; BASELINE.md's target is >= 80%
nnz/s scaling efficiency at N >= 2 cards).

One card is what this tool needs, so, as the JAX tool did on one chip,
the table combines three sources per rank count D in {1, 2, 4, 8}:

* the sharded formulations run for real on D gloo CPU ranks
  (`parallel/dist.py:spawn_ranks`): the strip formulation
  (`spgemm_sharded_strip`) checked against scipy (rtol 1e-4) and the
  exact-f64 Ozaki formulation (`spgemm_sharded_ozaki`) checked bit for
  bit; each rank's wall and collective ms (StepTimer) are host-CPU
  numbers, written under gloo_* names, never as card times;
* the partition's load balance: max/mean tile pairs per rank, the
  quantity that sets the compute side of the efficiency;
* a modelled per-rank step time: the slowest rank's pair share of the
  anchor (the strip kernel's ms on this matrix on one card, measured
  here on the card, or --anchor-ms) beside the B all-gather, (D-1)/D of
  B's bytes over one H100 SXM's NVLink rate in one direction (450 GB/s,
  NVIDIA's data sheet: 900 GB/s bidirectional). Efficiency(D) =
  t(1) / (D * t(D)). Every model column is named modelled_*.

Usage (from the repository root):
  python -m spgemm_tpu_torch.tools.scale_suite [--n 8192] [--band 64]
      [--devs 1,2,4,8] [--out data_h100/scale_suite.csv]
      [--anchor-ms MS] [-d cpu]

The anchor is measured on the card unless --anchor-ms gives it; `-d cpu`
needs --anchor-ms (a CPU time is not a card time).
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

NVLINK_BW = 450e9   # H100 SXM NVLink, bytes/s in one direction (data sheet)


def make_matrix(n: int, band: int):
    """The JAX tool's matrix: a +-band band, half of it kept at random
    (default_rng(7)), plus the diagonal, integer values 1..9."""
    from spgemm_tpu_torch.models.csr import CSR

    rng = np.random.default_rng(7)
    offs = np.arange(-band, band + 1, dtype=np.int64)
    r = np.repeat(np.arange(n, dtype=np.int64), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n) & (rng.random(r.size) < 0.5)
    keep |= r == c
    return CSR.from_coo(r[keep], c[keep],
                        rng.integers(1, 10, int(keep.sum())).astype(
                            np.float64), (n, n))


def _tiles(a, tm: int, tn: int):
    from spgemm_tpu_torch.models.tile import csr_to_tiles

    at = csr_to_tiles(a, tm, tn)
    return at, (at if tm == tn else csr_to_tiles(a, tn, tn))


def rank_run(n: int, band: int, tm: int, tn: int, block_rows: int) -> dict:
    """One gloo CPU rank: both formulations on this rank's mesh, checked
    against scipy; returns walls, collective ms and checks."""
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.parallel.dist import (make_mesh,
                                                spgemm_sharded_ozaki,
                                                spgemm_sharded_strip)
    from spgemm_tpu_torch.utils.timing import StepTimer

    a = make_matrix(n, band)
    at, bt = _tiles(a, tm, tn)
    ref = golden.spgemm_scipy(a, a)
    mesh = make_mesh(device="cpu")
    out = {}
    for form in ("strip", "ozaki"):
        timer = StepTimer()
        t0 = time.perf_counter()
        if form == "strip":
            c = spgemm_sharded_strip(at, bt, mesh, block_rows=block_rows,
                                     timer=timer)
        else:
            c = spgemm_sharded_ozaki(at, bt, mesh, timer=timer)
        wall = (time.perf_counter() - t0) * 1e3
        got = golden.drop_explicit_zeros(c.to_csr())
        ok = got.pattern_equal(ref) and (
            np.allclose(got.data, ref.data, rtol=1e-4, atol=1e-6)
            if form == "strip" else np.array_equal(got.data, ref.data))
        out[form] = dict(wall_ms=wall, ok=bool(ok),
                         collective_ms=timer.ms.get("collective", 0.0))
    return out


def _anchor_ms(args, at, bt) -> float:
    """The strip kernel's ms on this matrix on one card (CUDA events), or
    --anchor-ms. Raises without a card unless --anchor-ms is given."""
    if args.anchor_ms is not None:
        return args.anchor_ms
    from spgemm_tpu_torch.ops.executor import StripExecutor
    from spgemm_tpu_torch.utils.timing import resolve_device

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("-d cpu needs --anchor-ms: the anchor is a card "
                         "time")
    ms = StripExecutor(at, bt, block_rows=args.block_rows,
                       device=dev).time_numeric(warmup=3, iters=20)
    print(f"measured single-card strip kernel: {ms:.4f} ms")
    return ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m spgemm_tpu_torch.tools.scale_suite")
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--band", type=int, default=64)
    ap.add_argument("--tm", type=int, default=16)
    ap.add_argument("--tn", type=int, default=128)
    ap.add_argument("--block-rows", type=int, default=32)
    ap.add_argument("--out", default="data_h100/scale_suite.csv")
    ap.add_argument("--devs", default="1,2,4,8")
    ap.add_argument("--anchor-ms", type=float, default=None,
                    help="the strip kernel's ms on this matrix on one card "
                         "(default: measured on the card)")
    ap.add_argument("-d", "--device", default="cuda",
                    help="where the anchor is measured: cuda (default) or "
                         "cpu with --anchor-ms")
    args = ap.parse_args(argv)

    from spgemm_tpu_torch.models.csr import flop_count_spgemm
    from spgemm_tpu_torch.parallel.dist import (plan_strip_partition,
                                                spawn_ranks)
    from spgemm_tpu_torch.utils.timing import card_line

    a = make_matrix(args.n, args.band)
    at, bt = _tiles(a, args.tm, args.tn)
    print(f"matrix n={args.n} band={args.band} nnz={a.nnz} "
          f"nnzCub={flop_count_spgemm(a, a)}")
    t1_ms = _anchor_ms(args, at, bt)
    card = card_line() if args.anchor_ms is None else "anchor given"

    rows = []
    for d in [int(x) for x in args.devs.split(",")]:
        plan = plan_strip_partition(at, bt, d, block_rows=args.block_rows)
        bptr = bt.tptr.astype(np.int64)
        ppt = bptr[at.tcol.astype(np.int64) + 1] - bptr[at.tcol]
        per_row = np.zeros(at.gm, np.int64)
        np.add.at(per_row, at.trow, ppt)
        cum = np.concatenate([[0], np.cumsum(per_row)])
        per_dev = np.array([cum[plan.row_lo[i + 1]] - cum[plan.row_lo[i]]
                            for i in range(d)], dtype=np.int64)
        balance = float(per_dev.max() / max(per_dev.mean(), 1))

        ranks = spawn_ranks(rank_run, d, backend="gloo",
                            args=(args.n, args.band, args.tm, args.tn,
                                  args.block_rows))

        comp_ms = t1_ms * float(per_dev.max()) / max(plan.num_pairs, 1)
        b_bytes = plan.b_val.nbytes + plan.b_occ.nbytes
        comm_ms = (b_bytes * (d - 1) / d) / NVLINK_BW * 1e3
        t_d = max(comp_ms, comm_ms)
        eff = t1_ms / (d * t_d) if t_d > 0 else 1.0
        variant = "strip" + ("-window" if plan.kwin is not None
                             else "-cached")
        for form, label in (("strip", variant), ("ozaki", "ozaki-f64")):
            runs = [r[form] for r in ranks]
            check = "PASSED" if all(r["ok"] for r in runs) else "NOT PASSED"
            model = form == "strip"
            rows.append(dict(
                devices=d, variant=label, pairs_max=int(per_dev.max()),
                pairs_mean=float(per_dev.mean()), balance=round(balance, 3),
                gloo_cpu_wall_ms=round(max(r["wall_ms"] for r in runs), 1),
                gloo_cpu_collective_ms=round(
                    max(r["collective_ms"] for r in runs), 2),
                check=check,
                anchor_ms=round(t1_ms, 4) if model else "",
                modelled_compute_ms=round(comp_ms, 4) if model else "",
                modelled_allgather_ms=round(comm_ms, 4) if model else "",
                modelled_step_ms=round(t_d, 4) if model else "",
                modelled_scaling_efficiency=round(eff, 3) if model else "",
                card=card))
            print(f"D={d} {label}: balance={balance:.2f} gloo CPU wall="
                  f"{rows[-1]['gloo_cpu_wall_ms']}ms {check}"
                  + (f" modelled step={t_d:.4f}ms eff={eff:.2f}"
                     if model else ""), flush=True)
        if any(r["check"] != "PASSED" for r in rows[-2:]):
            print(f"D={d}: a formulation differs from scipy",
                  file=sys.stderr)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"-> {args.out}")
    return 0 if all(r["check"] == "PASSED" for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
