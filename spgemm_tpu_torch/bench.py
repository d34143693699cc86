"""Headline benchmark of the PyTorch/CUDA port (counterpart of the JAX
package's root `bench.py`). Prints ONE JSON line on stdout:

    {"metric": "spgemm_cantlike_gflops", "value": N, "unit": "GFLOPS",
     "vs_baseline": N, "e2e_ms": N, "sol_ms": N, "sol_pct": N,
     "f64_gflops": N, "f64_vs_baseline": N, "f64_int_gflops": N}

Run it from the repository root on a machine with one CUDA card:

    python -m spgemm_tpu_torch.bench

Workload: C = A^2 on the deterministic cant-like matrix
(`utils/generators.py:cantlike`, bit for bit `bench.py:make_cantlike`:
62,451^2, ~4.06 M nnz, nnzCub ~2.6e8) at 64x128 A tiles.

Metric: GFLOPS = 2*nnzCub / (symbolic_ms + numeric_ms), the reference's
formula (`src/tilespgemm-cuda.h:2808`, `bench.py:134-135`). symbolic_ms
is the host symbolic phase (C tile dictionary and slot table), best of
BENCH_REPEATS; numeric_ms the strip kernel's median CUDA-event time on
the resident plan (`StripExecutor.time_numeric`, BENCH_LOOP launches).
The plan's format prep and upload are one-time and reported apart.
e2e_ms = convert + symbolic + one run_compact() wall (kernel, device
compaction, download, TileMat assembly).

Bound: sol_ms is the card's bound for the strip kernel's work on this
plan (`utils/roofline.py:ChipSpec.h100`): the larger of the minimal bytes
(each operand plane and result plane read or written once: the plan's
device operands and the two C planes) over HBM's 3.35 TB/s and the
operations this run's data needs (the integer model's operands are TF32
values: one TF32 product a multiply-add, and the 0/1 count products in
bf16) over their peaks: the bytes, as in `chip_smoke.py`'s strip bound.
sol_pct = 100*sol_ms/numeric_ms, the card's roofline share; above 100
the bound is wrong and the run fails. (sol_ms used to be the JAX
package's modelled TPU traffic, `StripArgs.traffic_bytes()["total"]`,
which counts more bytes than the product needs and so is no bound on
this kernel: a kernel faster than it failed the run. A stderr line
prints that model's figure, as information.)

f64 rows, as `bench.py:177-231`: the Ozaki strip kernel and its
compaction gather (`time_ozaki_strip`, as the reference times them) on
the Gaussian cant-like (seed 11) at 32x128 (f64_gflops; a stderr line
gives the kernel alone) and on the integer model (f64_int_gflops), and
the double-double scan on random8192 (seed 7, 16 nnz per row), a stderr
line with its CUDA-event and its device time. A row that raises ends the
run non-zero; BENCH_F64=0 skips them.

Baseline: 52.63 GFLOPS (the reference GPU's best cant run,
`data/results_tile.csv`).

Env knobs: BENCH_ROWS, BENCH_BAND, BENCH_REPEATS, BENCH_LOOP (timed
launches), BENCH_TM/BENCH_TN (any BENCH_TM % 8 == 0, BENCH_TN % 128 == 0
runs the strip kernel, as the root bench.py's strip kernel takes them),
BENCH_BLOCK_ROWS, BENCH_F64.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROWS = int(os.environ.get("BENCH_ROWS", 62451))
BAND = int(os.environ.get("BENCH_BAND", 64))
REPEATS = int(os.environ.get("BENCH_REPEATS", 5))
LOOP = int(os.environ.get("BENCH_LOOP", 50))
TM = int(os.environ.get("BENCH_TM", 64))
TN = int(os.environ.get("BENCH_TN", 128))
BLOCK_ROWS = int(os.environ.get("BENCH_BLOCK_ROWS", 32))
BASELINE_GFLOPS = 52.63
DEV = "cuda"                    # every step runs on the card


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        _log("bench: no CUDA device (the benchmark times the card)")
        return 1

    from spgemm_tpu_torch.models.csr import CSR, flop_count_spgemm
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import ozaki_kernels
    from spgemm_tpu_torch.ops.esc import (build_esc_scan_plan,
                                          device_ms_esc_scan_dd,
                                          time_esc_scan_dd)
    from spgemm_tpu_torch.ops.executor import StripExecutor
    from spgemm_tpu_torch.ops.gustavson import run_strip_symbolic
    from spgemm_tpu_torch.ops.ozaki import build_ozaki_strip, time_ozaki_strip
    from spgemm_tpu_torch.utils.generators import cantlike
    from spgemm_tpu_torch.utils.roofline import ChipSpec
    from spgemm_tpu_torch.utils.timing import card_line, cuda_event_ms

    card = card_line()
    _log(f"# card: {card}")
    a = cantlike(ROWS, BAND)
    nnz_cub = flop_count_spgemm(a, a)
    _log(f"# matrix {ROWS}x{ROWS} nnz={a.nnz} nnzCub={nnz_cub} "
         f"tiles={TM}x{TN} device=cuda:0 ({torch.cuda.get_device_name(0)})")

    # best-of-3 warm conversion; drop the previous run's tiles first
    convert_ms = float("inf")
    at = bt = None
    for _ in range(3):
        at = bt = None
        t0 = time.perf_counter()
        at = csr_to_tiles(a, TM, TN)
        bt = at if TM == TN else csr_to_tiles(a, TN, TN)
        convert_ms = min(convert_ms, (time.perf_counter() - t0) * 1e3)
    _log(f"# convert_ms={convert_ms:.1f} ntA={at.nt} ntB={bt.nt} "
         "(warm, best of 3)")

    ex = StripExecutor(at, bt, block_rows=BLOCK_ROWS, device=DEV)
    sargs = ex.args
    _log(f"# prep_ms={sargs.prep_ms:.1f} symbolic_ms={sargs.symbolic_ms:.2f} "
         f"pairs={sargs.num_pairs} ntC={sargs.nt_c} kwin={sargs.kwin}")

    # the per-run symbolic phase alone (operand packing is one-time prep)
    sym_best = sargs.symbolic_ms
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        run_strip_symbolic(at, bt, BLOCK_ROWS, sargs.max_b, sargs.max_ablock)
        sym_best = min(sym_best, (time.perf_counter() - t0) * 1e3)

    # warm-up + correctness scalar: structural nonzeros of the real
    # candidate tiles (gather_idx picks them out of the block padding)
    c_val, c_cnt = ex.run()
    gidx = torch.from_numpy(sargs.gather_idx.astype(np.int64)).to(DEV)
    nnz_c = int((c_cnt.index_select(0, gidx) > 0).sum().item())
    min_bytes = _nbytes(ex._dev) + _nbytes((c_val, c_cnt))
    del c_val, c_cnt

    numeric_ms = ex.time_numeric(warmup=3, iters=LOOP)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_tiles = ex.run_compact()
    compact_wall = (time.perf_counter() - t0) * 1e3
    e2e_ms = convert_ms + sym_best + compact_wall

    runtime_ms = sym_best + numeric_ms
    gflops = 2.0 * nnz_cub / (runtime_ms * 1e6)

    chip = ChipSpec.h100()
    tr = sargs.traffic_bytes()
    products = float(sargs.num_pairs) * TM * sargs.tk * TN
    # the integer model's operands are TF32 values: one TF32 product each
    ops = [(2.0 * products, "tf32"), (2.0 * products, "bf16")]
    _, ops_ms, sol_ms, sol_by = chip.bound(min_bytes, ops)
    tpu_ms = chip.bound(tr["total"], ops)[2]
    sol_pct = 100.0 * sol_ms / numeric_ms

    _log(f"# numeric_ms={numeric_ms:.4f} symbolic_ms={sym_best:.4f} "
         f"runtime_ms={runtime_ms:.4f} nnzC={nnz_c} "
         f"compression={nnz_cub / max(nnz_c, 1):.2f} ({card})")
    _log(f"# e2e_ms={e2e_ms:.1f} (convert {convert_ms:.1f} + symbolic "
         f"{sym_best:.1f} + numeric/compact/download/assemble "
         f"{compact_wall:.1f}) nnzC_tiles={c_tiles.nt}")
    _log(f"# roofline (the card's bound, chip_smoke.py's: each operand and "
         f"result once): {min_bytes / 1e6:.0f} MB, operations "
         f"{ops_ms:.4f} ms -> SoL {sol_ms:.4f} ms ({sol_by}), attained "
         f"{numeric_ms:.4f} ms ({sol_pct:.1f}% of SoL) ({card})")
    _log(f"# for information, the JAX package's TPU traffic model (no bound "
         f"on this kernel): A={tr['a'] / 1e6:.0f}MB "
         f"B={tr['b'] / 1e6:.0f}MB "
         f"C={tr['c'] / 1e6:.0f}MB compact={tr['compact'] / 1e6:.0f}MB "
         f"-> {tpu_ms:.4f} ms at the card's HBM rate")
    if sol_pct > 100.0:
        raise RuntimeError(f"sol_pct {sol_pct:.1f} > 100: the bound exceeds "
                           "the measured time")
    del ex, c_tiles
    torch.cuda.empty_cache()

    # the same plan shape with Gaussian values: every k step takes the
    # exact three-way TF32 split (six products, not one)
    ag = a.with_data(np.random.default_rng(0).standard_normal(a.nnz))
    exg = StripExecutor(csr_to_tiles(ag, TM, TN), csr_to_tiles(ag, TN, TN),
                        block_rows=BLOCK_ROWS, device=DEV)
    g_ms = exg.time_numeric(warmup=3, iters=LOOP)
    _log(f"# strip kernel on Gaussian values (the exact split): "
         f"numeric_ms={g_ms:.4f} pairs={exg.args.num_pairs} ({card})")
    del exg, ag
    torch.cuda.empty_cache()

    out = {
        "metric": "spgemm_cantlike_gflops",
        "value": round(gflops, 2),
        "unit": "GFLOPS",
        "vs_baseline": round(gflops / BASELINE_GFLOPS, 3),
        "e2e_ms": round(e2e_ms, 1),
        "sol_ms": round(sol_ms, 3),
        "sol_pct": round(sol_pct, 1),
    }
    if os.environ.get("BENCH_F64", "1") != "0":
        az = a.with_data(np.random.default_rng(11).standard_normal(a.nnz))
        pz = build_ozaki_strip(csr_to_tiles(az, 32, TN),
                               csr_to_tiles(az, TN, TN))
        oz_ms = time_ozaki_strip(pz, device=DEV)
        f64_gflops = 2.0 * flop_count_spgemm(az, az) / (oz_ms * 1e6)
        _log(f"# f64 general (ozaki strip S={pz.sa}x{pz.sb}, cant-scale "
             f"gaussian): {oz_ms:.4f} ms = {f64_gflops:.1f} f64-GFLOPS "
             f"({f64_gflops / BASELINE_GFLOPS:.2f}x baseline)")
        ops8, kw8 = pz.to_device(DEV), pz.kernel_kwargs()
        ok_ms = cuda_event_ms(
            lambda: ozaki_kernels.ozaki_strip_numeric(*ops8, **kw8))
        _log(f"# ozaki strip kernel alone: {ok_ms:.4f} ms; the compaction "
             f"gather of its four planes the other {oz_ms - ok_ms:.4f} ms "
             f"({card})")
        del ops8
        del pz
        pi = build_ozaki_strip(csr_to_tiles(a, 32, TN),
                               csr_to_tiles(a, TN, TN))
        oi_ms = time_ozaki_strip(pi, device=DEV)
        f64_int_gflops = 2.0 * nnz_cub / (oi_ms * 1e6)
        _log(f"# f64 integer model (ozaki strip S={pi.sa}x{pi.sb}, "
             f"bit-exact): {oi_ms:.4f} ms = {f64_int_gflops:.1f} f64-GFLOPS "
             f"({f64_int_gflops / BASELINE_GFLOPS:.2f}x baseline)")
        del pi
        torch.cuda.empty_cache()

        rng = np.random.default_rng(7)
        nf = 8192
        af = CSR.from_coo(
            rng.integers(0, nf, nf * 16), rng.integers(0, nf, nf * 16),
            rng.integers(1, 10, nf * 16).astype(np.float64), (nf, nf))
        pf = build_esc_scan_plan(af, af)
        f64_ms = time_esc_scan_dd(pf, af.data, af.data, iters=LOOP)
        dd_dev_ms = device_ms_esc_scan_dd(pf, af.data, af.data, iters=LOOP)
        dd_gf = 2.0 * pf.num_products / (f64_ms * 1e6)
        _log(f"# f64 (double-double scan, random8192): {f64_ms:.4f} ms = "
             f"{dd_gf:.1f} f64-GFLOPS (unstructured-f64 route)")
        _log(f"# f64 double-double scan device time (torch.profiler): "
             f"{dd_dev_ms:.4f} ms = "
             f"{2.0 * pf.num_products / (dd_dev_ms * 1e6):.1f} f64-GFLOPS "
             f"({card})")
        out["f64_gflops"] = round(f64_gflops, 1)
        out["f64_vs_baseline"] = round(f64_gflops / BASELINE_GFLOPS, 3)
        out["f64_int_gflops"] = round(f64_int_gflops, 1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
