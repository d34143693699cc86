"""Command-line entry point (port of `spgemm_tpu/cli.py`), the analogue of the
reference's `./test` binary:

    python -m spgemm_tpu_torch [-d cuda:N] [-aat 0|1] A.mtx [tile_m tile_n]

Prints the same lines as the JAX package's CLI (matrix info, load time,
tile size, flops, conversion ms, format space, step times, tile/nnz
counts, runtime + GFLOPS, check verdict) and appends the four CSV sinks;
the route it took (`stats["backend"]`) goes to stderr. On the card every
tile_m % 8 == 0, tile_n % 128 == 0 shape runs the hand kernels (strip,
pair, Ozaki). `--backend` takes the JAX CLI's auto|strip|gustavson|dense|esc|xla|pallas|
ozaki: auto sends unstructured inputs to the ESC scan route and the rest
to the tiled router (the strip kernel where it runs, else dense, slab or
pair gather: any tile size runs, TileSpGEMM's 16x16 included), gustavson
runs the slab route, dense the padded dense matmul, ozaki the f64 Ozaki
route, pallas the per-C-tile pair kernel and xla the same pairs as torch
ops. `--dtype f64` follows spgemm_csr's f64 routing (structured inputs
run the Ozaki route; the torch-op routes multiply in float64) and exits
2 where the backend refuses the dtype (pallas is float32).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spgemm_tpu_torch",
        description="tiled SpGEMM on CUDA: C = A^2 or C = A*A^T",
    )
    p.add_argument("-d", "--device", default="cuda:0",
                   help="torch device, cuda:N (cpu runs the plain PyTorch "
                        "versions of the kernels)")
    p.add_argument("-aat", type=int, choices=[0, 1], default=0,
                   help="1: C = A*A^T, 0: C = A^2 (reference: -aat)")
    p.add_argument("matrix", help="Matrix Market file (.mtx[.gz])")
    p.add_argument("tile_m", nargs="?", type=int, default=16)
    p.add_argument("tile_n", nargs="?", type=int, default=128)
    p.add_argument("--backend", default="auto",
                   choices=["auto", "strip", "gustavson", "dense", "esc",
                            "xla", "pallas", "ozaki"])
    p.add_argument("--dtype", default="f32", choices=["f32", "f64"])
    p.add_argument("--check", default="values",
                   choices=["none", "pattern", "values"],
                   help="oracle comparison level (reference checks pattern)")
    p.add_argument("--csv-dir", default=None,
                   help="append result CSVs to this directory")
    p.add_argument("--repeat", type=int, default=1,
                   help="best-of repeat count (reference REPEAT_NUM)")
    p.add_argument("--synthetic-values", action="store_true",
                   help="overwrite values with i%%10 (reference main.cu:111)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from spgemm_tpu_torch.io.mmio import read_mtx
    from spgemm_tpu_torch.models.csr import flop_count_spgemm
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr
    from spgemm_tpu_torch.utils import csv_sink
    from spgemm_tpu_torch.utils.timing import resolve_device

    compute_dtype = torch.float64 if args.dtype == "f64" else torch.float32
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    name_dev = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "host CPU, plain PyTorch versions")
    print(f"device: {dev} ({name_dev})")

    t0 = time.perf_counter()
    a, is_sym = read_mtx(args.matrix)
    load_s = time.perf_counter() - t0
    name = os.path.basename(args.matrix).removesuffix(".gz").removesuffix(".mtx")
    print(f"matrix: {name}  m={a.m} n={a.n} nnz={a.nnz} "
          f"symmetric={int(is_sym)}")
    print(f"load time: {load_s:.3f} s")

    if args.synthetic_values:
        a = a.with_sequential_values()
    if args.aat and is_sym:
        # the reference refuses AAT on symmetric inputs (main.cu:120-124)
        print("AAT on a symmetric matrix equals A^2; computing A^2 instead",
              file=sys.stderr)
        args.aat = 0
    if not args.aat and a.m != a.n:
        print("error: C = A^2 requires a square matrix (use -aat 1)",
              file=sys.stderr)
        return 2

    tm, tn = args.tile_m, args.tile_n
    print(f"tile size: {tm} x {tn}  (B tiles {tn} x {tn})")

    b_csr = a.transpose() if args.aat else a
    nnz_cub = flop_count_spgemm(a, b_csr)
    print(f"nnzCub (flops base): {nnz_cub}  "
          f"({2*nnz_cub/1e9:.3f} GFLOP)")

    t0 = time.perf_counter()
    at = csr_to_tiles(a, tm, tn)
    convert_ms = (time.perf_counter() - t0) * 1e3
    csr_mb = (a.indptr.nbytes + a.indices.nbytes + a.data.nbytes) / 1e6
    tile_mb = at.total_bytes() / 1e6
    print(f"CSR->tile conversion: {convert_ms:.2f} ms  "
          f"(numtile(A)={at.nt})")
    print(f"space: CSR {csr_mb:.2f} MB vs tiled {tile_mb:.2f} MB")

    best = None
    best_runtime = float("inf")
    for _ in range(max(1, args.repeat)):
        try:
            c, res = spgemm_csr(a, aat=bool(args.aat), tm=tm, tn=tn,
                                backend=args.backend,
                                compute_dtype=compute_dtype, device=dev)
        except (NotImplementedError, ValueError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        rt = res.timings_ms["symbolic_ms"] + res.timings_ms["numeric_ms"]
        if rt < best_runtime:
            best_runtime, best = rt, (c, res)
    c, res = best

    tms = res.timings_ms
    # the route on stderr: stdout keeps the JAX CLI's lines
    print(f"route: {res.stats['backend']}", file=sys.stderr)
    # a phase or counter the route does not have prints as "-"
    ms = lambda k: f"{tms[k]:.2f} ms" if k in tms else "-"
    nb = lambda k: f"{int(res.stats[k])} B" if k in res.stats else "-"
    passes = res.stats.get("ozaki_passes")
    print(f"step times: route {ms('route_ms')}, tile {ms('tile_ms')}, "
          f"slice {ms('slice_ms')}, "
          f"symbolic {tms['symbolic_ms']:.2f} ms, "
          f"upload {tms['upload_ms']:.2f} ms, "
          f"numeric {tms['numeric_ms']:.2f} ms, "
          f"compact {tms['compact_ms']:.2f} ms, "
          f"download {ms('download_ms')}, result {ms('result_ms')}; "
          f"h2d {nb('h2d_bytes')}, d2h {nb('d2h_bytes')}, "
          f"ozaki passes {'-' if passes is None else int(passes)}")
    print(f"numtile(C): {int(res.stats['numblkC'])} "
          f"(candidates {int(res.stats['numblkC_candidate'])})")
    print(f"nnz(C): {c.nnz}  compression: "
          f"{res.stats.get('compression', float('nan')):.2f}")
    gflops = 2.0 * nnz_cub / (best_runtime * 1e6) if best_runtime else 0.0
    print(f"runtime: {best_runtime:.2f} ms  ({gflops:.2f} GFLOPS)")
    print("note: wall-clock timings include upload, compaction and "
          "download; chip_smoke.py times the kernel with CUDA events")

    verdict = "SKIPPED"
    if args.check != "none":
        ref = golden.spgemm_scipy(a, b_csr)
        got = golden.drop_explicit_zeros(c)
        pattern_ok = got.pattern_equal(ref)
        if args.check == "pattern":
            verdict = "PASSED" if pattern_ok else "NOT PASSED"
        else:
            tol = 1e-12 if args.dtype == "f64" else 1e-5
            ok = pattern_ok and np.allclose(got.data, ref.data, rtol=tol)
            verdict = "PASSED" if ok else "NOT PASSED"
        print(f"check ({args.check} vs scipy oracle): [{verdict}]")

    if args.csv_dir:
        d = args.csv_dir
        csv_sink.append_row(
            os.path.join(d, "results_tile.csv"), csv_sink.RESULTS_HEADER,
            [name, a.m, a.n, a.nnz, tm, tn, c.nnz,
             round(res.stats.get("compression", 0), 4),
             round(best_runtime, 4), round(gflops, 4),
             args.backend, args.dtype],
        )
        csv_sink.append_row(
            os.path.join(d, "step_runtime.csv"), csv_sink.STEP_HEADER,
            [name, a.m, a.n, a.nnz, tm, tn,
             round(tms["symbolic_ms"], 4), round(tms["upload_ms"], 4),
             round(tms["numeric_ms"], 4), round(tms["compact_ms"], 4)],
        )
        csv_sink.append_row(
            os.path.join(d, "mem-cost.csv"), csv_sink.MEM_HEADER,
            [name, a.m, a.n, a.nnz, tm, tn, round(csr_mb, 4),
             round(tile_mb, 4)],
        )
        csv_sink.append_row(
            os.path.join(d, "preprocessing.csv"), csv_sink.PREPROC_HEADER,
            [name, a.m, a.n, a.nnz, tm, tn, round(convert_ms, 4)],
        )

    return 0 if verdict in ("PASSED", "SKIPPED") else 1


if __name__ == "__main__":
    sys.exit(main())
