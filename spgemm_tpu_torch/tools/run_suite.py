"""Benchmark suite runner of the PyTorch/CUDA port (counterpart of the
JAX package's `tools/run_suite.py`, the analogue of the reference's
`data/run18.sh` / `data/run142.sh` loops over a family of deterministic
synthetic matrices: banded FEM-like, block-diagonal, random uniform,
power-law rows, R-MAT).

For each (matrix, config) it runs C = A^2, C = A*A^T and SpMM k = 128
through the library API on the card (or, with `-d cpu`, the plain
PyTorch versions on the host), checks every product against the scipy
oracle, and appends the four CSV sinks (results_tile.csv,
step_runtime.csv, mem-cost.csv, preprocessing.csv; their matrix column
is "<name>_<config>") and suite_summary.csv, whose columns are the JAX
package's plus `dtype` (f32 and f64 runs share one summary; --resume
skips the (matrix, config, dtype) rows already there) and `card`
(nvidia-smi's name and power limit). SpMM128 rows are checked too
(Y = A*X against scipy, rtol 1e-5); with --dtype f64 they run in float64
(the tile fallback on the card, whose device time is not measured).
As in the JAX runner, --dtype f64 keeps the suite's integer values, so
the f64 router sends them to the f32 routes, exact by its 2^24 bound
(backend "...(f64-exact-int)").

Device times (CUDA events, median; blank on the CPU): the strip kernel
(+ symbolic) on the plan spgemm_csr built; the Ozaki strip kernel or the
slab engine; the ESC scan kernel (premul; mul_ms the in-kernel-multiply
variant, whose arithmetic is the strip kernel's accounting) or, where an
f64 row ran it, the double-double scan kernel; the dense step; the SpMM
kernel (resident X), or the gather SpMM where the kernel's resident mode
does not apply.

Usage (from the repository root):
  python -m spgemm_tpu_torch.tools.run_suite [--outdir data_h100] [--n N]
      [--dtype f32|f64] [--configs A2,AAT,SpMM128] [--resume] [-d cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
import time

import numpy as np

SUMMARY_HEADER = ["matrix", "config", "m", "nnzA", "nnzC", "nnzCub",
                  "runtime_ms", "plan_ms", "wall_ms", "gflops", "device_ms",
                  "mul_ms", "device_gflops", "check", "backend", "dtype",
                  "card"]


def suite(quick: bool, n: int | None = None) -> dict:
    """The JAX runner's five matrices at n (8192 with --quick, else
    65536), bit for bit."""
    from spgemm_tpu_torch.utils.generators import suite as gen_suite

    return gen_suite(n or (8192 if quick else 65536))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m spgemm_tpu_torch.tools.run_suite")
    ap.add_argument("--outdir", default="data_h100")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--mtx", nargs="*", default=[],
                    help="additional Matrix Market files")
    ap.add_argument("--n", type=int, default=None, help="matrix dimension")
    ap.add_argument("--only", default=None, help="substring filter on names")
    ap.add_argument("--tm", type=int, default=16)
    ap.add_argument("--tn", type=int, default=128)
    ap.add_argument("--backend", default=None,
                    help="default: auto on the card, gustavson on the CPU")
    ap.add_argument("--dtype", default="f32", choices=["f32", "f64"],
                    help="f64 routes structured regimes to the Ozaki "
                         "engine, unstructured to the double-double scan")
    ap.add_argument("--configs", default="A2,AAT,SpMM128",
                    help="comma-set of A2,AAT,SpMM128 to run")
    ap.add_argument("--resume", action="store_true",
                    help="skip (matrix, config, dtype) rows already in the "
                         "summary")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="save/load converted tile formats as .npz")
    ap.add_argument("-d", "--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap


def _device_times(res, a, aat: bool, args, nnz_cub: int, dev):
    """(device_ms, mul_ms, device_gflops) of the route spgemm_csr took, by
    CUDA events on its plan; blanks on the CPU and for the torch-op routes
    without a timer (gustavson, xla)."""
    if dev.type != "cuda":
        return "", "", ""
    from spgemm_tpu_torch.ops.esc import (ScanPlan, time_esc_scan,
                                          time_esc_scan_dd)
    from spgemm_tpu_torch.ops.executor import EscExecutor, StripExecutor
    from spgemm_tpu_torch.ops.gustavson import StripArgs
    from spgemm_tpu_torch.ops.ozaki import (OzakiPlan, OzakiStripPlan,
                                            time_ozaki, time_ozaki_strip)

    gf = lambda ms: round(2 * nnz_cub / (ms * 1e6), 2) if ms else ""
    backend = str(res.stats.get("backend", ""))
    sched = res.schedule
    if backend.startswith("strip") and isinstance(sched, StripArgs):
        ms = StripExecutor.from_args(sched, device=dev).time_numeric(
            warmup=3, iters=20) + res.timings_ms.get("symbolic_ms", 0)
        return round(ms, 3), "", gf(ms)
    if isinstance(sched, OzakiStripPlan):
        ms = time_ozaki_strip(sched, device=dev)
        return round(ms, 3), "", gf(ms)
    if isinstance(sched, OzakiPlan):
        ms = time_ozaki(sched, device=dev)
        return round(ms, 3), "", gf(ms)
    if isinstance(sched, ScanPlan):
        if args.dtype == "f64" and "f64-exact-int" not in backend:
            b = a.transpose() if aat else a
            ms = time_esc_scan_dd(sched, a.data, b.data)
            return round(ms, 3), "", gf(ms)
        ms = time_esc_scan(sched, device=dev)
        mul = EscExecutor(sched, mode="mul", device=dev).time_numeric(
            warmup=3, iters=20)
        return round(ms, 3), round(mul, 3), gf(mul)
    if backend.startswith("dense"):
        from spgemm_tpu_torch.models.tile import csr_to_tiles
        from spgemm_tpu_torch.ops.spgemm import time_dense

        a_t = csr_to_tiles(a, args.tm, args.tn)
        b_t = (csr_to_tiles(a.transpose(), args.tn, args.tn) if aat
               else (a_t if args.tm == args.tn
                     else csr_to_tiles(a, args.tn, args.tn)))
        ms = time_dense(a_t, b_t, device=dev)
        return round(ms, 3), "", gf(ms)
    return "", "", ""


def _spmm_device_ms(at, a, x, dev):
    """Device ms of SpMM k=128: the strip kernel with X resident, or the
    gather SpMM where the resident mode does not apply (time_spmm's
    ValueError says so). Blank on the CPU."""
    if dev.type != "cuda":
        return ""
    from spgemm_tpu_torch.ops.spmm import time_spmm, time_spmm_gather

    try:
        return time_spmm(at, x, device=dev)
    except ValueError:
        return time_spmm_gather(a, x, device=dev)


def _sink_rows(d, tag, a, args, c, res, nnz_cub, rt, gflops, convert_ms,
               tile_mb) -> None:
    """One row in each of the four CSV sinks (the CLI's columns)."""
    from spgemm_tpu_torch.utils import csv_sink

    tms = res.timings_ms
    key = [tag, a.m, a.n, a.nnz, args.tm, args.tn]
    csv_sink.append_row(
        os.path.join(d, "results_tile.csv"), csv_sink.RESULTS_HEADER,
        key + [c.nnz, round(nnz_cub / c.nnz, 4) if c.nnz else 0,
               round(rt, 4), round(gflops, 4),
               str(res.stats.get("backend", args.backend)), args.dtype])
    csv_sink.append_row(
        os.path.join(d, "step_runtime.csv"), csv_sink.STEP_HEADER,
        key + [round(tms.get(k, 0.0), 4) for k in
               ("symbolic_ms", "upload_ms", "numeric_ms", "compact_ms")])
    csr_mb = (a.indptr.nbytes + a.indices.nbytes + a.data.nbytes) / 1e6
    csv_sink.append_row(
        os.path.join(d, "mem-cost.csv"), csv_sink.MEM_HEADER,
        key + [round(csr_mb, 4), round(tile_mb, 4)])
    csv_sink.append_row(
        os.path.join(d, "preprocessing.csv"), csv_sink.PREPROC_HEADER,
        key + [round(convert_ms, 4)])


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import scipy.sparse as sp
    import torch

    from spgemm_tpu_torch.io import checkpoint
    from spgemm_tpu_torch.io.mmio import read_mtx
    from spgemm_tpu_torch.models.csr import flop_count_spgemm
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr
    from spgemm_tpu_torch.ops.spmm import spmm
    from spgemm_tpu_torch.utils import csv_sink
    from spgemm_tpu_torch.utils.timing import card_line, resolve_device

    dev = resolve_device(args.device)
    if args.backend is None:
        # auto resolves strip for structured patterns and esc for
        # unstructured ones; the CPU runs gustavson, as the JAX runner
        args.backend = "auto" if dev.type == "cuda" else "gustavson"
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"device: {dev} ({card})", flush=True)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)

    mats = suite(args.quick, args.n)
    if args.only:
        mats = {k: v for k, v in mats.items() if args.only in k}
    for path in args.mtx:
        name = os.path.basename(path).removesuffix(".mtx")
        mats[name], _ = read_mtx(path)

    os.makedirs(args.outdir, exist_ok=True)
    summary = os.path.join(args.outdir, "suite_summary.csv")
    done: set[tuple[str, str]] = set()
    if args.resume and os.path.exists(summary):
        with open(summary) as f:
            reader = csv.DictReader(f)
            if reader.fieldnames != SUMMARY_HEADER:
                raise SystemExit(f"{summary} has other columns than this "
                                 "runner writes; move it away to resume")
            done = {(row["matrix"], row["config"], row["dtype"])
                    for row in reader}
        print(f"resume: {len(done)} completed rows in {summary}")

    want = {c.strip() for c in args.configs.split(",") if c.strip()}
    dt = torch.float64 if args.dtype == "f64" else torch.float32
    for name, a in mats.items():
        print(f"=== {name}: m={a.m} nnz={a.nnz}", flush=True)
        at = None
        if args.checkpoint_dir:
            os.makedirs(args.checkpoint_dir, exist_ok=True)
            ck = os.path.join(args.checkpoint_dir,
                              f"{name}_t{args.tm}x{args.tn}.npz")
            if os.path.exists(ck):
                at = checkpoint.load(ck)
        t0 = time.perf_counter()
        if at is None:
            at = csr_to_tiles(a, args.tm, args.tn)
            if args.checkpoint_dir:
                checkpoint.save(ck, at)
        convert_ms = (time.perf_counter() - t0) * 1e3
        tile_mb = at.total_bytes() / 1e6
        for cfg, aat in (("A2", False), ("AAT", True)):
            if cfg not in want:
                continue
            if (name, cfg, args.dtype) in done:
                print(f"  {cfg}: skipped (resume)", flush=True)
                continue
            b_chk = a.transpose() if aat else a
            nnz_cub = flop_count_spgemm(a, b_chk)
            kw = dict(aat=aat, tm=args.tm, tn=args.tn, backend=args.backend,
                      compute_dtype=dt, device=dev)
            spgemm_csr(a, **kw)  # warm-up: kernel builds, first touches
            t0 = time.perf_counter()
            c, res = spgemm_csr(a, **kw)
            wall_ms = (time.perf_counter() - t0) * 1e3
            rt = (res.timings_ms.get("symbolic_ms", 0)
                  + res.timings_ms.get("numeric_ms", 0))
            gflops = 2 * nnz_cub / (rt * 1e6) if rt else 0
            # every run is checked (the reference checks every run,
            # main.cu:325-350): full scipy compare up to 4e9 flops, an
            # exact row-sample compare beyond (512 rows)
            if nnz_cub < 4_000_000_000:
                ref = golden.spgemm_scipy(a, b_chk)
                ok = golden.drop_explicit_zeros(c).allclose(ref, rtol=1e-5)
                verdict = "PASSED" if ok else "NOT PASSED"
            else:
                rows = np.unique(np.random.default_rng(0).integers(
                    0, a.m, 512))
                ok = golden.rows_match_oracle(c, a, b_chk, rows, rtol=1e-5)
                verdict = "PASSED(sample)" if ok else "NOT PASSED"
            dev_ms, mul_ms, dev_gflops = _device_times(res, a, aat, args,
                                                       nnz_cub, dev)
            backend = str(res.stats.get("backend", args.backend))
            csv_sink.append_row(
                summary, SUMMARY_HEADER,
                [name, cfg, a.m, a.nnz, c.nnz, nnz_cub, round(rt, 3),
                 round(res.timings_ms.get("symbolic_ms", 0), 3),
                 round(wall_ms, 1), round(gflops, 2), dev_ms, mul_ms,
                 dev_gflops, verdict, backend, args.dtype, card])
            _sink_rows(args.outdir, f"{name}_{cfg}", a, args, c, res,
                       nnz_cub, rt, gflops, convert_ms, tile_mb)
            print(f"  {cfg}: nnzC={c.nnz} runtime={rt:.2f}ms "
                  f"gflops={gflops:.2f} device_ms={dev_ms} "
                  f"device_gflops={dev_gflops} backend={backend} {verdict}",
                  flush=True)
        if "SpMM128" not in want:
            continue
        if (name, "SpMM128", args.dtype) in done:
            print("  SpMM128: skipped (resume)", flush=True)
            continue
        x = np.ones((a.n, 128), np.float32)
        spmm(at, x, dtype=dt, device=dev)  # warm-up
        sync()
        t0 = time.perf_counter()
        y = spmm(at, x, dtype=dt, device=dev)
        sync()
        spmm_ms = (time.perf_counter() - t0) * 1e3
        ref_y = sp.csr_matrix((a.data, a.indices, a.indptr),
                              shape=a.shape) @ x.astype(np.float64)
        ok = np.allclose(y.cpu().numpy(), ref_y, rtol=1e-5)
        verdict = "PASSED" if ok else "NOT PASSED"
        dms = _spmm_device_ms(at, a, x, dev) if args.dtype == "f32" else ""
        spmm_dev_ms = round(dms, 3) if dms != "" else ""
        spmm_dev_gf = round(2 * 128 * a.nnz / (dms * 1e6), 2) \
            if dms != "" else ""
        csv_sink.append_row(
            summary, SUMMARY_HEADER,
            [name, "SpMM128", a.m, a.nnz, "", 128 * a.nnz,
             round(spmm_ms, 3), "", round(spmm_ms, 1),
             round(2 * 128 * a.nnz / (spmm_ms * 1e6), 2),
             spmm_dev_ms, "", spmm_dev_gf, verdict, "spmm", args.dtype,
             card])
        print(f"  SpMM128: {spmm_ms:.2f} ms device_ms={spmm_dev_ms} "
              f"{verdict}", flush=True)
    print(f"summary -> {summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
