"""Smoke run of the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases (each prints a line; any failure exits non-zero, with no result):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the strip kernel, the ESC scan kernels, the Ozaki strip
     kernel, the SpMM strip kernel, the pair kernel and the gather kernel
     from spgemm_tpu_torch/csrc with nvcc (one nvcc per source, all six
     started together) and print the build seconds and each kernel's
     ptxas registers and spills (the four strip, four pair and four
     128-column SpMM instantiations, one per chunk height, must launch at
     <= 168 registers, and they, the three scan kernels and the sixteen
     narrow SpMM instantiations must not spill; the five Ozaki
     instantiations must launch at <= 168 registers; ptxas must not
     serialise the strip, pair, SpMM or Ozaki kernels' wgmmas);
  3. compare the strip kernel with its plain PyTorch version on the card,
     on random banded plans: 64x128 and 16x128 A tiles (B 128x128),
     integer values (equal exactly) and Gaussian values (rtol 1e-5, atol
     1e-6*max|C|), in both plan shapes (windowed and window=False);
     counts must be equal exactly in every case;
  4. drive the strip path, C = A^2 on the 62,451^2 cant-like matrix of
     bench.py, through spgemm_csr(device="cuda") and through
     StripExecutor.run_compact(), with the launch counters zeroed just
     before: C's pattern must equal the scipy oracle's and its values be
     exactly equal (integer model), the kernel must have launched and
     the plain version must not have run;
  5. time it: symbolic_ms (host, best of 5), the kernel's numeric_ms and
     the plain version's on the same plan (CUDA events, median), the
     kernel's device time (torch.profiler), its bound and the bound's
     share of the kernel's time, and GFLOPS = 2*nnzCub / (symbolic_ms +
     numeric_ms) as bench.py counts it; print ptxas's registers and
     spills per tile height and time torch.sparse.mm(A, A) on the same
     matrix;
     then time the kernel on the window=False plan and on the main plan
     with standard-normal values (the integer model's operands are TF32
     values and take one tensor-core product per k step; Gaussian values
     take the exact three-way TF32 split, six products), each checked
     against the plain version
     (Gaussian: rtol 1e-5, atol 1e-6*max|C|, counts equal);
  6. compare the three scan kernels (premul, mul, double-double) with
     their plain versions on a random 8192^2 and a full banded 2048^2
     (band 40: 7 passes, windows taller than COMBINE_K) plan, G = 1 and 4,
     integer and Gaussian values: bit-equal (torch.equal) in every case;
     then spgemm(tiles, tiles, backend="esc") on a random 8192^2 in f32
     (equal to scipy exactly) and f64 (rtol 1e-10, atol 1e-11*max|C|),
     through the scan kernels;
  7. drive the ESC path at full size, C = A^2 on the JAX suite's
     rmat65536 (tools/run_suite.py), through spgemm_csr(device="cuda")
     (auto routing must pick esc) and EscExecutor.run_csr() in modes
     premul and mul, counters zeroed just before: C equal to the scipy
     oracle (pattern and values exactly), the scan kernels launched and
     their plain versions not run;
  8. drive the f64 path: random65536 with standard-normal values through
     spgemm_csr(compute_dtype=float64): within rtol 1e-10, atol
     1e-11*max|C| of scipy, through the double-double kernel;
  9. time the ESC path at rmat65536 (host plan, upload, kernels and their
     plain versions with CUDA events, combine, download) and print device
     GFLOPS = 2*F / mul-kernel ms;
 10. compare the Ozaki strip kernel with its plain version on random
     banded plans: 16x128 and 32x128 A tiles, integer values (S = 1),
     Gaussian values (S = 8x8) at the plan's pmax 7 and at pmax 14 (all
     groups), and Gaussian A times wide-integer B (sa != sb) at pmax
     below, at and past sa+sb-2: h, m, l and counts bit-equal
     (torch.equal) in every case;
 11. drive the structured f64 path: C = A^2 on the cant-like matrix with
     default_rng(0) standard-normal values through
     spgemm_csr(tm=32, compute_dtype=float64, device="cuda"), counters
     zeroed just before: auto routing must pick ozaki-strip(S=8x8), the
     kernel must launch and its plain version must not run, C's pattern
     must equal scipy's and its error be at most 1e-12*max|C|; then the
     integer model through spgemm(backend="ozaki") at S = 1, equal to
     scipy exactly;
 12. time it: symbolic_ms (host, best of 5), the kernel's ms (CUDA
     events, median of 30) and the plain version's on the same plan (bit
     equal there too), f64 GFLOPS = 2*nnzCub / (symbolic_ms + kernel ms),
     spgemm_csr's phase split, the peak device memory, the call's device
     time by kernel (the K-major copy of B, the wgmma kernel) and the
     bound with and without the copy's bytes;
 13. compare the SpMM strip kernel with its plain version on random banded
     plans: 16x128 and 64x128 A tiles, packed widths 256 (k 200), 1 and
     8 (k 1) and 32 (k 20), resident and window form, integer values (equal
     exactly) and Gaussian values (rtol 1e-5, atol 1e-6*max|Y|);
 14. drive the SpMM path at full size on the suite's banded65536 (16x128
     tiles), counters zeroed just before each route: spmm with k = 128
     and spmv must take the kernel's resident form, spmm with k = 256 its
     window form (X over the L2 budget), and spmm on rmat65536 with
     k = 128 the gather route; each Y within rtol 1e-5, atol 1e-6*max|Y|
     of scipy's A @ X, the kernel launched where its route runs and the
     plain version never; spmv through the narrow form (packed at 1
     column, A read by its sector map) and k = 128 and 256 through the
     128-column form;
 15. time the SpMM kernel and its plain version (CUDA events, median of
     20) on the banded65536 operands at k = 128, SpMV and k = 256, beside
     torch.sparse.mm(A, X) and torch.mv(A, x), with GFLOPS = 2*nnz*k /
     kernel ms, and the gather route's device time at rmat65536; k = 128
     and 256 also with integer X (bit-equal; "integer_ms" and
     "integer_device_ms" in their JSON entries); SpMV
     and torch.mv also with the L2 cache flushed before each timed call;
     SpMV's bound from its occupied sectors, the dense-tile bound beside;
 16. compare the pair kernel with its plain version on random banded
     plans: 16x128 and 64x128 A tiles (B 128x128), float32 and bfloat16
     occupancy, integer values (equal exactly), Gaussian values (rtol
     1e-5), counts > 0 equal;
 17. drive the pair backends: C = A^2 on the cant-like matrix at 64x128
     through spgemm_csr(backend="pallas") and ("xla"), counters zeroed
     just before each: C equal to the scipy oracle (pattern and values
     exactly), the pair kernel launched on "pallas" and its plain version
     never; then time the kernel (bfloat16 occupancy, as the backend
     uploads it) and its plain version on that schedule, with integer
     and with standard-normal values (rtol 1e-5), the bound counted on
     the reference's float32 planes and the bytes the kernel moves
     printed beside it;
 18. drive the Gustavson slab route (torch ops, no hand kernel): C = A^2
     on the cant-like matrix at TileSpGEMM's 16x16 tiles through
     spgemm_csr(tm=16, tn=16): auto routing must pick gustavson, C equal
     to scipy exactly (integer model), also A*A^T; standard-normal values
     through backend="strip" must report gustavson(strip-fallback: ...)
     and match scipy within rtol 1e-5, atol 1e-6*max|C|;
 19. drive the dense route: the suite's banded8192 A^2 at 16x16 (auto
     must pick dense), C equal to scipy exactly; a cancelling product
     keeps its stored zero;
 20. drive the f64 slab engine: the cant-like A^2 with standard-normal
     values at 16x16 through spgemm_csr(compute_dtype=float64) must run
     ozaki(S=8x8)(xla-fallback) within 1e-12*max|C| of scipy; its (h, m,
     l, counts) on the leading 4,096^2 cut must be bit-equal to the CPU's
     ozaki_core on the same plan; an arrow pattern (no windowed plan) at
     32x128 through backend="ozaki" takes it too and matches scipy;
 21. OzakiExecutor on phase 20's plan: run + assemble (one pass, the
     plan's own slices) equal to the one-pass slab engine's C
     (spgemm(backend="ozaki"); phase 20's auto route adds the hi/lo
     passes); update_values with new values, rerun, within 1e-12*max|C|.
     Phases 18-21 zero the launch counters first and fail if any hand
     kernel or plain kernel version ran. Each route's timing lines start
     with the card's name and power limit: symbolic, upload and numeric
     ms (CUDA events, median), the device split by aten op
     (torch.profiler), compact ms and wall, the bytes the numeric step
     moves over 3.35 TB/s beside its operations bound, torch.sparse.mm
     on the same product (f64 for the slab engine), and GFLOPS =
     2*nnzCub/(symbolic + numeric);
 22. the ESC digit mode (torch ops, no hand kernel) on the suite's
     random65536: spgemm_esc(mode="digit") with integer values (equal to
     scipy), standard-normal values in f32 (rtol 1e-5, atol
     1e-6*max|C|) and in float64 (rtol 1e-10, atol 1e-11*max|C|); its
     numeric ms (time_esc, CUDA events), device split by aten op, bound,
     peak device memory against the unchunked temporaries, and
     torch.sparse.mm on the same A;
 23-28. the example applications (spgemm_tpu_torch/examples), each run
     once under torch.profiler (wall time, device time, host time), with
     the launch counters zeroed just before; each phase fails if a plain
     kernel version ran or a hand kernel of its route did not launch
     (per spgemm_csr call, the kernel of the route it printed):
     23 triangle_counting on random_graph(262144, 16), the count equal
     to scipy's sum(A .* A^2)/6; 24 amg_galerkin at g = 1024, 2 levels,
     its own check; 25 markov_clustering at n = 8192, each iteration's
     expansion against scipy (rtol 1e-5, atol 1e-6*max|C|); 26 pagerank
     on rmat(65536, 16), within L1 1e-5 of the same iteration count in
     f64, and the two-hop pattern through spgemm_esc equal to scipy's
     (the scan kernel launched); 27 power_method at n = 1,048,576, band
     8: 150 narrow SpMM launches, lambda within 1e-5 of the f64 Rayleigh
     quotient, the per-iteration ms; 28 serving_loop at n = 16,384
     (SERVE_N says why not 65,536), every tick OK, the strip and the
     premul scan kernels launched;
 29. entry() on the card equals the CPU's result;
 30. dist-1, the multi-device layer (spgemm_tpu_torch/parallel/dist.py)
     in a one-rank NCCL process group on the card, every formulation at
     full size with the counters zeroed before each: the strip shard on
     the cant-like A^2 at 64x128 (C equal to scipy and to spgemm_csr's C,
     the strip kernel launched, no plain version; Gaussian values at rtol
     1e-5), ESC on rmat65536 (C exact, the scan kernel launched, no skew
     fallback), gustavson, ring and pairs on the cant-like A^2 at 16x16
     (exact, no hand kernel; their gathered bytes and temporaries printed
     and held under 16 GiB), Ozaki f64 at 16x128 (integer values equal
     to scipy, Gaussian within 1e-12*max|C|); each prints the card's name
     and limit, then plan, upload, kernel (CUDA events), collective
     (torch.profiler: the device time under the c10d ops) and assembly
     ms and the wall;
 31. dist-2: two processes on the one card over gloo (GLOO_CUDA_FORMS:
     the formulations whose collectives gloo carries on CUDA tensors, the
     ring's not), each rank owning at least two strip blocks: every C
     equal on both ranks, to the one-rank C and to the golden C, the
     strip and scan kernels launched on each rank, no plain version;
 32. dryrun_multichip(1) in the one-rank group (its OK line), then the
     group is destroyed;
 33-35. the tools through their entry points, each in a fresh
     interpreter (`python -m` through runpy, so the module's own
     __main__ block runs) whose launch counters start at 0 and are read
     at its end: 33 `spgemm_tpu_torch.bench` at full size: its last line
     holds every key of the root bench.py, value > 0, sol_pct <= 100, its
     nnzC equal to scipy's nnz of the cant-like A^2 (phase 4) and its
     numeric_ms within 10% of phase 5's; the strip, Ozaki and DD kernels
     launched; 34 `spgemm_tpu_torch.tools.verify_cuda`: FAILS: 0, the
     strip, scan (premul, mul, DD), Ozaki and SpMM kernels launched;
     35 `spgemm_tpu_torch.tools.run_suite --n 8192 --configs A2` into a
     temporary directory: every row PASSED, the strip and scan kernels
     launched. No phase may run a plain version;
 36. the strip, pair, Ozaki and SpMM kernels at tile shapes past their
     compiled heights (each tm % 8 == 0, tn % 128 == 0 tile runs as row
     chunks of 64/32/16/8 rows, the Ozaki kernel's 32/16/8, and
     128-column chunks, 64 for Ozaki; SpMM as sub-tiles of one height),
     against their plain versions on random banded plans: strip (both
     plan shapes) and pair at 24x128, 128x128, 8x256 and 40x384; Ozaki at
     8x128, 64x128 and 24x256 (h, m, l, counts bit-equal); SpMM at tm 24
     and 128, k 1 (narrow form), 128 and 256, resident and window;
     integer values exact, Gaussian values within rtol 1e-5, atol
     1e-6*max|C|;
 37. the main path at those shapes at full size, counters zeroed before
     each route: the cant-like A^2 through spgemm_csr at 128x128 and
     40x256 (auto must pick strip, only the strip kernel may launch;
     integer values equal to scipy, Gaussian within rtol 1e-5), through
     backend="pallas" at 128x128 (the pair kernel, exact), in f64 at
     64x128 (auto must pick ozaki-strip(S=8x8), within 1e-12*max|C|; the
     integer model through backend="ozaki" exact), and spmm/spmv on
     banded65536 at 128x128 (resident k = 128, SpMV through the narrow
     form, window k = 256; within rtol 1e-5 of scipy); no plain version
     may run. Each kernel's time there (CUDA events) is printed beside
     its bound and the compiled shape's time from phases 5, 12, 15, 17;
 38. (run after phase 17: after the multi-device phases torch.profiler
     reads no device time on the card) the gather kernel
     (take_along_blocks, csrc/dyngather.cu) against its plain version,
     bit-equal, at the dynamic-gather probe's nine shapes
     and at C = 1,024 (16,384 rows, blk 256 on axis 1, blk 512 on axis
     0); its time (CUDA events, torch.profiler), bound and torch.gather's
     at the probe's largest case; then the TwoSum rounding probe's
     kernel (csrc/twosum_probe.cu, verify_cuda's) at its 1,024 elements;
 39. the three probes through their entry points, each in a fresh
     interpreter as in phases 33-35, writing into a temporary directory:
     probe_dyngather (every case ok, take_along_blocks launched, no plain
     version), probe_sort (the nine rows, then the three full-array sort
     rows at F = 400,458,682, rmat65536 A^2's products) and
     probe_primitives (nine rows); each file starts with the card's line;
 41. (run after phase 12) the auto f64 route's hi/lo passes on top3d's
     SIMP stiffness (perfbench/matrices/top3d.py) at 24x8x4 elements in
     64x128 tiles, whose rows span more bits than the slices hold:
     spgemm_csr(compute_dtype=float64) must run four passes, four
     kernel launches and no plain version, give the CPU's plain run's C
     bit for bit, stay within 1e-12 of the plain reference entry by entry
     (|C - C_ref| / (|A||A|)_ij) and download at most 16 bytes a
     candidate slot; its phase split;
 42. (run after phase 41) C's entries picked on the card
     (gustavson.pick_tiles) at the top3d.a2 cell's full mesh, 90x30x6
     elements (perfbench/configs/top3d.json), in 64x128 tiles, f32 (the
     strip route) and f64 (the four Ozaki passes): one spgemm_csr call of
     each after a warm-up, its download and compact spans, d2h_bytes
     (equal to the picked arrays' bytes, beside the dense planes' figure
     it replaces) and peak device memory; then the route's own planes on
     the card, picked there and, copied, on the CPU, and assembled on the
     host by _compact_to_tilemat: the three TileMats equal array for
     array, values bit for bit;
 40. print the kernels JSON line (the ten hand kernels, each with the
     tile shapes it was held at against its plain version, "tiles", and
     its phase-37 times, "chunked"), then the contract line {"ok": true,
     "device": {...}} as the last line.

Beside every kernel's time the script prints (phase bound) its bound_ms:
the larger of the bytes its operands and results take, each read or
written once, over 3.35 TB/s, and its operations over the H100's peak for
their type (f32 products counted as three TF32 products, the card's
fastest f32-accurate rate); and (phase library) library_ms, the median
time of the one PyTorch call that computes the same function
(torch.sparse.mm, torch.mv), or the error where that call cannot run.
The port never calls those; they are yardsticks.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROWS, BAND = 62451, 64          # bench.py's cant-like matrix
TM, TN = 64, 128                # bench.py's tiles: A 64x128, B 128x128
GAUSS_RTOL = 1e-5               # f32, summation order differs
SUITE_N = 65536                 # tools/run_suite.py's full-size suite
F64_RTOL, F64_ATOL = 1e-10, 1e-11  # tests/test_esc.py:334 (atol x max|C|)
OZ_TM = 32                      # the tile height the JAX route was tuned at
OZ_RTOL = 1e-12                 # tests/test_ozaki.py:306 (x max|C|)
SPMM_TM = 16                    # tools/run_suite.py's SpMM128 tiles: 16x128
SPMM_K = 128                    # the suite's SpMM128 width


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def compare_random_plans() -> None:
    """Phase 3: kernel against plain version on random plans."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import kernels
    from spgemm_tpu_torch.ops.gustavson import build_strip_args
    from spgemm_tpu_torch.utils.generators import banded

    rng = np.random.default_rng(7)
    for tm in (64, 16):
        for window in (None, False):
            for values in ("integer", "gaussian"):
                a = banded(rng, 6000, 64)
                if values == "gaussian":
                    a = a.with_data(rng.standard_normal(a.nnz))
                args = build_strip_args(csr_to_tiles(a, tm, TN),
                                        csr_to_tiles(a, TN, TN),
                                        window=window)
                check((args.kwin is None) == (window is False),
                      f"plan shape: window={window} gave kwin={args.kwin}")
                ops = args.to_device("cuda")
                kw = args.kernel_kwargs()
                cv, cc = kernels.strip_numeric(*ops, **kw)
                pv, pc = kernels.strip_numeric_plain(*ops, **kw)
                torch.cuda.synchronize()
                err = (cv - pv).abs().max().item()
                scale = pv.abs().max().item()
                if values == "integer":
                    ok = torch.equal(cv, pv)
                else:
                    ok = torch.allclose(cv, pv, rtol=GAUSS_RTOL,
                                        atol=1e-6 * scale)
                print(f"phase compare: tiles {tm}x{TN} window={window} "
                      f"kwin={args.kwin} {values} slots={cv.shape[0]} "
                      f"max_abs_err={err!r} max_abs={scale!r} "
                      f"values_ok={ok} counts_equal={torch.equal(cc, pc)}")
                check(ok, f"kernel values disagree ({tm}x{TN}, {window}, "
                          f"{values}): max_abs_err {err}")
                check(torch.equal(cc, pc), "kernel counts disagree")


def build_kernels() -> None:
    """Phase 2: one nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from spgemm_tpu_torch.ops import (gather_kernels, kernels, ozaki_kernels,
                                      pair_kernels, scan_kernels,
                                      spmm_kernels)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        futs = [pool.submit(kernels.load_strip_kernel),
                pool.submit(scan_kernels.load_scan_kernel),
                pool.submit(ozaki_kernels.load_ozaki_kernel),
                pool.submit(spmm_kernels.load_spmm_kernel),
                pool.submit(pair_kernels.load_pair_kernel),
                pool.submit(gather_kernels.load_gather_kernel)]
        for f in futs:
            f.result()
    print(f"phase build: six sources in {time.perf_counter() - t0!r} s")
    usage = {}
    for info in (kernels.build_info, scan_kernels.build_info,
                 ozaki_kernels.build_info, spmm_kernels.build_info,
                 pair_kernels.build_info, gather_kernels.build_info):
        print(f"phase build: {info['seconds']!r} s -> {info['path']}")
        for fn, (regs, st, ld) in sorted(
                kernels.ptxas_usage(info["ptxas"]).items()):
            usage[fn] = (regs, st, ld)
            print(f"phase build: ptxas {fn}: {regs} registers, {st} bytes "
                  f"spill stores, {ld} bytes spill loads")
    # the main plans' instantiations: the Ozaki kernel (one 384-thread
    # CTA a SM: <= 168 registers at launch) at every height and group
    # count, and the three scan kernels must not spill
    oz = {fn: v for fn, v in usage.items() if "ozaki_wgmma_kernel" in fn}
    scan = [v for fn, v in usage.items() if "esc_scan_kernel" in fn]
    print(f"phase build: Ozaki kernel, (registers at launch, spill stores, "
          f"spill loads) by instantiation: {oz}")
    check(len(oz) == 5 and all(v[0] <= 168 for v in oz.values()),
          f"an Ozaki kernel instantiation needs more than 168 registers: "
          f"{oz}")
    oz_serial = kernels.serialised_wgmma(ozaki_kernels.build_info["ptxas"])
    print(f"phase build: Ozaki kernel, ptxas reports of serialised wgmma "
          f"(C7511, C7513, C7515): {oz_serial}")
    check(oz_serial == 0,
          "ptxas serialised the Ozaki kernel's wgmma instructions")
    check(len(scan) == 3 and all(v[1:] == (0, 0) for v in scan),
          f"the scan kernels spill: {scan}")
    # the strip and pair kernels' pipeline and SpMM's 128-column form (one
    # 384-thread CTA a SM: <= 168 registers at launch) at every height: no
    # spills, and ptxas must not serialise their wgmmas
    for name, info in (("strip_numeric_kernel", kernels.build_info),
                       ("pair_accumulate_kernel", pair_kernels.build_info),
                       ("spmm_wgmma_kernel", spmm_kernels.build_info)):
        inst = {fn: v for fn, v in usage.items() if name in fn}
        serial = kernels.serialised_wgmma(info["ptxas"])
        print(f"phase build: {name}, (registers at launch, spill stores, "
              f"spill loads) by height: {sorted(inst.values())}; ptxas "
              f"reports of serialised wgmma (C7511, C7513, C7515): {serial}")
        check(len(inst) == 4 and all(v[0] <= 168 and v[1:] == (0, 0)
                                     for v in inst.values()),
              f"a {name} instantiation needs more than 168 registers or "
              f"spills: {inst}")
        check(serial == 0, f"ptxas serialised the {name}'s wgmmas")
    narrow = {fn: v for fn, v in usage.items() if "spmm_narrow_kernel" in fn}
    print(f"phase build: narrow SpMM form, (registers, spill stores, spill "
          f"loads) by instantiation: {sorted(narrow.values())}")
    check(len(narrow) == 16 and all(v[1:] == (0, 0)
                                    for v in narrow.values()),
          f"a narrow SpMM instantiation spills: {narrow}")


def compare_scan_kernels() -> None:
    """Phase 6: the three scan kernels against their plain versions."""
    import torch

    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops.esc import (COMBINE_K, build_esc_scan_plan,
                                          gather_planes, scan_dd_planes)
    from spgemm_tpu_torch.utils.generators import banded, random_uniform

    rng = np.random.default_rng(11)
    # the full band gives 7 passes and, at G=1, windows taller than
    # COMBINE_K rows
    mats = {"random8192": random_uniform(rng, 8192),
            "band2048": banded(rng, 2048, 40, fill=1.0)}
    for name, a0 in mats.items():
        for values in ("integer", "gaussian"):
            a = a0 if values == "integer" else a0.with_data(
                rng.standard_normal(a0.nnz))
            for g in (1, 4):
                plan = build_esc_scan_plan(a, a, group_rows=g)
                wr = np.diff(plan.win_rowptr) // g
                up = lambda x: torch.from_numpy(x).to("cuda")
                meta = up(plan.meta16())
                kw = dict(passes=plan.passes, group_rows=g)
                cases = (
                    ("esc_scan", sk.esc_scan, sk.esc_scan_plain,
                     (up(plan.qv),)),
                    ("esc_scan_mul", sk.esc_scan_mul, sk.esc_scan_mul_plain,
                     tuple(map(up, gather_planes(plan, a.data, a.data)))),
                    ("esc_scan_dd", sk.esc_scan_dd, sk.esc_scan_dd_plain,
                     tuple(map(up, scan_dd_planes(plan, a.data, a.data)))))
                for label, kern, plain, planes in cases:
                    got = _planes(kern(*planes, meta, **kw))
                    exp = _planes(plain(*planes, meta, **kw))
                    torch.cuda.synchronize()
                    equal = all(torch.equal(x, y) for x, y in zip(got, exp))
                    err = max((x - y).abs().max().item()
                              for x, y in zip(got, exp))
                    print(f"phase scan-compare: {name} {values} G={g} "
                          f"{label} R={plan.qv.shape[0]} "
                          f"passes={plan.passes} tall_windows="
                          f"{int((wr > COMBINE_K).sum())} max_abs_err={err!r} "
                          f"bit_equal={equal}")
                    check(equal, f"{label} differs from its plain version "
                                 f"({name}, {values}, G={g}): {err}")


def run_esc_tiles() -> None:
    """Phase 6b: spgemm(tiles, tiles, backend="esc") on a random 8192^2,
    f32 (integer values) and f64 (Gaussian): C back on tiles through the
    scan kernels, against the scipy oracle."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops.spgemm import spgemm
    from spgemm_tpu_torch.utils.generators import random_uniform

    a = random_uniform(np.random.default_rng(12), 8192)
    ag = a.with_data(np.random.default_rng(14).standard_normal(a.nnz))
    for label, x, dt, w in (("f32", a, torch.float32, sk.esc_scan),
                            ("f64", ag, torch.float64, sk.esc_scan_dd)):
        _zero_counters(sk.esc_scan, sk.esc_scan_dd)
        res = spgemm(csr_to_tiles(x, 16, TN), csr_to_tiles(x, TN, TN),
                     backend="esc", compute_dtype=dt, device="cuda")
        torch.cuda.synchronize()
        launches = (w.kernel_launches, w.plain_launches)
        print(f"phase esc-tiles: {label} tiles {res.c.tm}x{res.c.tn} "
              f"stats={res.stats} launches (kernel, plain)={launches}")
        check(res.stats["backend"] == "esc" and launches == (1, 0),
              f"spgemm(backend='esc') {label} did not run the scan kernel")
        ref = golden.spgemm_scipy(x, x)
        got = golden.drop_explicit_zeros(res.c.to_csr())
        if label == "f32":
            _check_exact("spgemm(tiles, backend=esc)", got, ref)
            continue
        pat = got.pattern_equal(ref)
        scale = float(np.abs(ref.data).max())
        close = pat and np.allclose(got.data, ref.data, rtol=F64_RTOL,
                                    atol=F64_ATOL * scale)
        print(f"phase check: spgemm(tiles, backend=esc) f64 pattern_equal="
              f"{pat} close={close}")
        check(close, "spgemm(tiles, backend=esc) f64 differs from scipy")


def _planes(out):
    return out if isinstance(out, tuple) else (out,)


def _zero_counters(*wrappers) -> None:
    for w in wrappers:
        w.kernel_launches = 0
        w.plain_launches = 0
        if hasattr(w, "narrow_launches"):
            w.narrow_launches = 0


def _check_exact(label, got, ref) -> None:
    from spgemm_tpu_torch.ops import golden

    got = golden.drop_explicit_zeros(got)
    pat = got.pattern_equal(ref)
    exact = pat and np.array_equal(got.data, ref.data)
    print(f"phase check: {label} nnzC={got.nnz} oracle nnzC={ref.nnz} "
          f"pattern_equal={pat} values_exact={exact}")
    check(pat and exact, f"{label} result differs from the scipy oracle")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _f32_mma_ops(products: float) -> list:
    """Operations of `products` f32 multiply-adds at the card's fastest
    f32-accurate rate: three TF32 tensor-core products each (3xTF32)."""
    return [(3 * 2.0 * products, "tf32")]


def _h100():
    """The H100 SXM's published peaks (spgemm_tpu_torch/utils/roofline.py:
    HBM bytes/s and dense operations/s by type), for every bound_ms."""
    from spgemm_tpu_torch.utils.roofline import ChipSpec

    return ChipSpec.h100()


def bound(label: str, inputs, outputs, ops=()) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes of `inputs` and
    `outputs` (each read or written once) over the H100's HBM rate and the
    operations `ops` [(count, type)] over the card's peak rate for their
    type. Prints the numbers behind it."""
    return bound_bytes(label, _nbytes(inputs) + _nbytes(outputs), ops)


def bound_bytes(label: str, moved: int, ops=()) -> tuple:
    """bound() for a byte count `moved` given directly."""
    chip = _h100()
    bytes_ms, ops_ms, ms, by = chip.bound(moved, ops)
    what = ", ".join(f"{n!r} {kind}" for n, kind in ops) or "none counted"
    print(f"phase bound: {label} bytes={moved} ({bytes_ms!r} ms at "
          f"{chip.peak_hbm_bw:.3g} B/s) ops=[{what}] ({ops_ms!r} ms at peak) "
          f"bound_ms={ms!r} bound_by={by}")
    return ms, by


def spmv_bound(label: str, t, ops, smap, y) -> tuple:
    """bound() of the narrow SpMM form, which reads A by sectors: the
    occupied 32-byte sectors (the sector map's set bits), the map, X, aptr,
    ak and Y, and the products of the occupied values. Prints the
    dense-tile bound (every A tile read whole) beside it."""
    a_dense, xb, aptr, ak, _ = ops
    width = y.shape[2]
    sectors = int(np.unpackbits(smap.cpu().numpy().view(np.uint8)).sum())
    dense = bound(f"{label} width={width} dense tiles", ops, (y,),
                  _f32_mma_ops(float(t.nt) * t.tm * t.tn * width))
    new = bound_bytes(
        f"{label} width={width} occupied sectors ({sectors} of "
        f"{t.nt * t.tm * -(-t.tn // 8)})",
        sectors * 32 + _nbytes((smap, xb, aptr, ak, y)),
        _f32_mma_ops(8.0 * sectors * width))
    print(f"phase bound: {label} dense-tile bound_ms={dense[0]!r} "
          f"occupied-sector bound_ms={new[0]!r}")
    return new


def _torch_csr(a, dtype):
    """`a` as a torch sparse CSR tensor on the card (int32 indices)."""
    import torch

    up = lambda v, dt: torch.from_numpy(np.ascontiguousarray(v, dt)).to("cuda")
    return torch.sparse_csr_tensor(up(a.indptr, np.int32),
                                   up(a.indices, np.int32),
                                   up(a.data, np.float64).to(dtype),
                                   size=a.shape)


def library_ms(label: str, fn, *, iters: int):
    """Median ms of one PyTorch library call `fn` (the yardstick beside a
    kernel; the port never calls it), or None with the error printed when
    the call cannot run at this shape."""
    import torch

    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    try:
        ms = cuda_event_ms(fn, warmup=1, iters=iters)
    except (RuntimeError, NotImplementedError) as e:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"phase library: {label} could not run: {type(e).__name__}: "
              f"{str(e).splitlines()[0][:300]}")
        return None
    print(f"phase library: {label} library_ms={ms!r}")
    return ms


def run_esc_path(suite: dict) -> list:
    """Phases 7 and 9: the ESC scan path at rmat65536, then its timings.
    Returns the kernels JSON entries of the premul and mul kernels."""
    import torch

    from spgemm_tpu_torch.ops import esc, golden, kernels
    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops.executor import EscExecutor
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr
    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    name = f"rmat{SUITE_N}"
    a = suite[name]
    _zero_counters(sk.esc_scan, sk.esc_scan_mul, sk.esc_scan_dd,
                   kernels.strip_numeric)
    t0 = time.perf_counter()
    c, res = spgemm_csr(a, device="cuda")
    csr_s = time.perf_counter() - t0
    check(res.stats["backend"] == "esc",
          f"auto routing picked {res.stats['backend']} for {name}")
    plan = res.schedule
    ex_p = EscExecutor(plan, mode="premul", device="cuda")
    c_p = ex_p.run_csr()
    ex_m = EscExecutor(plan, mode="mul", device="cuda")
    c_m = ex_m.run_csr()
    torch.cuda.synchronize()
    launches = {w.__name__: (w.kernel_launches, w.plain_launches)
                for w in (sk.esc_scan, sk.esc_scan_mul)}
    print(f"phase esc: {name} {a.m}x{a.n} nnz={a.nnz} spgemm_csr "
          f"{csr_s!r} s backend={res.stats['backend']} launches "
          f"(kernel, plain)={launches} strip kernel="
          f"{kernels.strip_numeric.kernel_launches}")
    check(all(k > 0 and p == 0 for k, p in launches.values()),
          f"the ESC path did not run through the scan kernels: {launches}")
    wr = np.diff(plan.win_rowptr) // plan.group_rows
    print(f"phase esc: plan F={plan.num_products} nnzC={plan.nnz_c} "
          f"R={plan.qv.shape[0]} G={plan.group_rows} passes={plan.passes} "
          f"windows={wr.size} tall_windows={int((wr > esc.COMBINE_K).sum())} "
          f"tallest={int(wr.max())} rows")
    t0 = time.perf_counter()
    ref = golden.spgemm_scipy(a, a)
    print(f"phase esc: scipy oracle {time.perf_counter() - t0!r} s")
    for label, got in (("spgemm_csr(esc)", c), ("EscExecutor(premul)", c_p),
                       ("EscExecutor(mul)", c_m)):
        _check_exact(label, got, ref)
    del c, c_p, c_m, ref

    # --- phase 9: timings ---------------------------------------------
    tms = res.timings_ms
    print(f"phase esc-time: spgemm_csr symbolic_ms={tms['symbolic_ms']!r} "
          f"upload_ms={tms['upload_ms']!r} numeric_ms={tms['numeric_ms']!r} "
          f"(kernel + combine) compact_ms={tms['compact_ms']!r} "
          f"(download + tail + host) wall_s={csr_s!r}")
    kw = dict(passes=plan.passes, group_rows=plan.group_rows)
    a_t = _torch_csr(a, torch.float32)
    lib_ms = library_ms(f"torch.sparse.mm(A_csr, A_csr) f32 at {name}",
                        lambda: torch.sparse.mm(a_t, a_t), iters=3)
    del a_t
    torch.cuda.empty_cache()
    entries = []
    for label, ex, plain in (("esc_scan", ex_p, sk.esc_scan_plain),
                             ("esc_scan_mul", ex_m, sk.esc_scan_mul_plain)):
        got = ex.run()
        exp = plain(*ex._vals, ex._meta, **kw)
        torch.cuda.synchronize()
        err = (got - exp).abs().max().item()
        check(torch.equal(got, exp), f"{label} differs from its plain "
                                     f"version at {name}: {err}")
        b_ms, b_by = bound(f"{label} at {name}", (*ex._vals, ex._meta),
                           (got,))
        del got, exp
        ms = ex.time_numeric(warmup=3, iters=20)
        plain_ms = cuda_event_ms(lambda: plain(*ex._vals, ex._meta, **kw),
                                 warmup=1, iters=5)
        print(f"phase esc-time: {label} kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r} max_abs_err={err!r}")
        entries.append(dict(
            name=label, route="cuda",
            source="spgemm_tpu_torch/csrc/esc_scan.cu",
            replaces={"esc_scan": "spgemm_tpu/ops/esc.py:662",
                      "esc_scan_mul": "spgemm_tpu/ops/esc.py:713"}[label],
            launches=launches[label][0], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))
    out = ex_p.run()
    combine_ms = cuda_event_ms(lambda: esc._combine_apply(plan, out),
                               warmup=1, iters=5)
    r, tail = esc._combine_apply(plan, out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r_h = r.cpu()
    dl_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    esc.esc_scan_trim_combined(plan, r_h, tail)
    trim_ms = (time.perf_counter() - t0) * 1e3
    gflops = 2.0 * plan.num_products / (entries[1]["ms"] * 1e6)
    print(f"phase esc-time: combine_ms={combine_ms!r} (device) "
          f"download_ms={dl_ms!r} ({r.numel() * 4} bytes) "
          f"tail+host_ms={trim_ms!r}")
    print(f"phase esc-time: device GFLOPS={gflops!r} (2*F / mul kernel ms); "
          f"peak device memory {torch.cuda.max_memory_allocated()!r} bytes")
    return entries


def run_f64_path(suite: dict) -> dict:
    """Phase 8: the double-double route on random65536, Gaussian values.
    Returns the kernels JSON entry of the DD kernel."""
    import torch

    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops.esc import scan_dd_planes
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr
    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    name = f"random{SUITE_N}"
    a0 = suite[name]
    a = a0.with_data(np.random.default_rng(23).standard_normal(a0.nnz))
    _zero_counters(sk.esc_scan, sk.esc_scan_mul, sk.esc_scan_dd)
    t0 = time.perf_counter()
    c, res = spgemm_csr(a, compute_dtype=torch.float64, device="cuda")
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    dd = (sk.esc_scan_dd.kernel_launches, sk.esc_scan_dd.plain_launches)
    plan = res.schedule
    print(f"phase f64: {name} nnz={a.nnz} F={plan.num_products} "
          f"nnzC={plan.nnz_c} R={plan.qv.shape[0]} G={plan.group_rows} "
          f"passes={plan.passes} backend={res.stats['backend']} "
          f"spgemm_csr {csr_s!r} s dd launches (kernel, plain)={dd}")
    check(dd[0] > 0 and dd[1] == 0, "the f64 path did not run the DD kernel")
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(c)
    pat = got.pattern_equal(ref)
    scale = float(np.abs(ref.data).max())
    close = pat and np.allclose(got.data, ref.data, rtol=F64_RTOL,
                                atol=F64_ATOL * scale)
    rel = (float(np.max(np.abs(got.data - ref.data)
                        / np.maximum(np.abs(ref.data), 1e-300)))
           if pat else float("nan"))
    print(f"phase check: f64 {name} pattern_equal={pat} close={close} "
          f"max_rel_err={rel!r} max|C|={scale!r}")
    check(close, "f64 result differs from the scipy oracle")

    up = lambda x: torch.from_numpy(x).to("cuda")
    planes = tuple(map(up, scan_dd_planes(plan, a.data, a.data)))
    meta = up(plan.meta16())
    kw = dict(passes=plan.passes, group_rows=plan.group_rows)
    got, exp = sk.esc_scan_dd(*planes, meta, **kw), \
        sk.esc_scan_dd_plain(*planes, meta, **kw)
    torch.cuda.synchronize()
    err = max((x - y).abs().max().item() for x, y in zip(got, exp))
    check(all(torch.equal(x, y) for x, y in zip(got, exp)),
          f"esc_scan_dd differs from its plain version at {name}: {err}")
    b_ms, b_by = bound(f"esc_scan_dd at {name}", (*planes, meta), got)
    del got, exp
    a_t = _torch_csr(a, torch.float64)
    lib_ms = library_ms(f"torch.sparse.mm(A_csr, A_csr) f64 at {name}",
                        lambda: torch.sparse.mm(a_t, a_t), iters=3)
    del a_t
    ms = cuda_event_ms(lambda: sk.esc_scan_dd(*planes, meta, **kw),
                       warmup=3, iters=20)
    plain_ms = cuda_event_ms(lambda: sk.esc_scan_dd_plain(*planes, meta,
                                                          **kw),
                             warmup=1, iters=5)
    print(f"phase f64-time: esc_scan_dd kernel_ms={ms!r} "
          f"plain_ms={plain_ms!r} max_abs_err={err!r} timings_ms="
          f"{ {k: round(v, 3) for k, v in res.timings_ms.items()} }")
    return dict(name="esc_scan_dd", route="cuda",
                source="spgemm_tpu_torch/csrc/esc_scan.cu",
                replaces="spgemm_tpu/ops/esc.py:760", launches=dd[0],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def compare_ozaki_plans() -> None:
    """Phase 10: the Ozaki strip kernel against its plain version."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops.ozaki import build_ozaki_strip
    from spgemm_tpu_torch.utils.generators import banded

    rng = np.random.default_rng(13)
    for tm in (16, 32):
        a = banded(rng, 3000, 64)
        ag = a.with_data(rng.standard_normal(a.nnz))
        aw = a.with_data(rng.integers(-2 ** 20, 2 ** 20, a.nnz)
                         .astype(np.float64))
        # (label, A, B, expected (sa, sb), pmax values; None = the plan's)
        cases = (("integer", a, a, (1, 1), (None,)),
                 ("gaussian", ag, ag, (8, 8), (None, 14)),
                 ("gaussian x wide-int", ag, aw, (8, 3), (2, None, 9, 14)))
        for label, x, y, sizes, pmaxes in cases:
            plan = build_ozaki_strip(csr_to_tiles(x, tm, TN),
                                     csr_to_tiles(y, TN, TN))
            check((plan.sa, plan.sb) == sizes,
                  f"{label}: S={plan.sa}x{plan.sb}, expected {sizes}")
            ops = plan.to_device("cuda")
            for pm in pmaxes:
                kw = plan.kernel_kwargs()
                if pm is not None:
                    kw["pmax"] = pm
                got = ok.ozaki_strip_numeric(*ops, **kw)
                exp = ok.ozaki_strip_numeric_plain(*ops, **kw)
                torch.cuda.synchronize()
                equal = [torch.equal(g, e) for g, e in zip(got, exp)]
                err = max((g - e).abs().max().item()
                          for g, e in zip(got, exp))
                print(f"phase ozaki-compare: tiles {tm}x{TN} {label} "
                      f"S={plan.sa}x{plan.sb} pmax={kw['pmax']} "
                      f"slots={got[0].shape[0]} max_abs_err={err!r} "
                      f"bit_equal(h, m, l, cnt)={equal}")
                check(all(equal), f"the Ozaki kernel differs from its plain "
                                  f"version ({tm}x{TN}, {label}, pmax "
                                  f"{kw['pmax']}): {err}")


def run_ozaki_path(a_int, ref_int) -> dict:
    """Phases 11 and 12: the structured f64 path on the cant-like matrix
    with Gaussian values, the integer model through backend="ozaki",
    then the timings. Returns the kernels JSON entry of the Ozaki kernel."""
    import torch

    from spgemm_tpu_torch.models.csr import flop_count_spgemm
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden, kernels
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops.gustavson import run_strip_symbolic
    from spgemm_tpu_torch.ops.spgemm import spgemm, spgemm_csr
    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    oz = ok.ozaki_strip_numeric
    others = (kernels.strip_numeric, sk.esc_scan, sk.esc_scan_mul,
              sk.esc_scan_dd)
    a = a_int.with_data(np.random.default_rng(0).standard_normal(a_int.nnz))
    nnz_cub = flop_count_spgemm(a, a)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counters(oz, *others)
    t0 = time.perf_counter()
    c, res = spgemm_csr(a, tm=OZ_TM, tn=TN, compute_dtype=torch.float64,
                        device="cuda")
    torch.cuda.synchronize()
    csr_s = time.perf_counter() - t0
    csr_peak = torch.cuda.max_memory_allocated()
    launches = (oz.kernel_launches, oz.plain_launches)
    other = {w.__name__: w.kernel_launches + w.plain_launches for w in others}
    plan = res.schedule
    s = plan.sargs
    print(f"phase f64-strip: cant-like {ROWS}x{ROWS} Gaussian nnz={a.nnz} "
          f"nnzCub={nnz_cub} backend={res.stats['backend']} spgemm_csr "
          f"{csr_s!r} s; plan S={plan.sa}x{plan.sb} pmax={plan.pmax} "
          f"stack_rows={plan.stack_rows} av8={plan.av8.shape} "
          f"bv8={plan.bv8.shape} kwin={s.kwin} max_b={s.max_b} "
          f"max_ablock={s.max_ablock} max_cblock={s.max_cblock} "
          f"block_rows={s.block_rows} nt_c={s.nt_c} pairs={s.num_pairs} "
          f"padded_slots={-(-s.gm // s.block_rows) * s.max_cblock}")
    print(f"phase f64-strip: launches (kernel, plain)={launches} "
          f"other wrappers={other}")
    check(res.stats["backend"] == "ozaki-strip(S=8x8)",
          f"auto routing picked {res.stats['backend']} for the f64 cant-like")
    check(launches[0] >= 1 and launches[1] == 0,
          f"the f64 path did not run through the Ozaki kernel: {launches}")
    t0 = time.perf_counter()
    ref = golden.spgemm_scipy(a, a)
    print(f"phase f64-strip: scipy oracle {time.perf_counter() - t0!r} s")
    got = golden.drop_explicit_zeros(c)
    pat = got.pattern_equal(ref)
    scale = float(np.abs(ref.data).max())
    c_err = float(np.abs(got.data - ref.data).max()) if pat else float("inf")
    print(f"phase check: f64 cant-like nnzC={got.nnz} oracle nnzC={ref.nnz} "
          f"pattern_equal={pat} max_abs_err={c_err!r} max|C|={scale!r} "
          f"err/max|C|={c_err / scale!r} (limit {OZ_RTOL})")
    check(pat and c_err <= OZ_RTOL * scale,
          "f64 cant-like result differs from the scipy oracle")
    del c, got, ref

    at_int = csr_to_tiles(a_int, OZ_TM, TN)
    bt_int = csr_to_tiles(a_int, TN, TN)
    _zero_counters(oz)
    ires = spgemm(at_int, bt_int, backend="ozaki", device="cuda")
    torch.cuda.synchronize()
    ilaunch = (oz.kernel_launches, oz.plain_launches)
    print(f"phase f64-strip: integer model backend={ires.stats['backend']} "
          f"launches (kernel, plain)={ilaunch}")
    check(ires.stats["backend"] == "ozaki-strip(S=1x1)"
          and ilaunch[0] >= 1 and ilaunch[1] == 0,
          "the integer model did not run the Ozaki kernel at S=1")
    _check_exact("spgemm(backend=ozaki) integer", ires.c.to_csr(), ref_int)
    del ires, at_int, bt_int

    # --- phase 12: timings at the main plan ---------------------------
    at = csr_to_tiles(a, OZ_TM, TN)
    bt = csr_to_tiles(a, TN, TN)
    sym_ms = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        run_strip_symbolic(at, bt, s.block_rows, s.max_b, s.max_ablock)
        sym_ms = min(sym_ms, (time.perf_counter() - t0) * 1e3)
    ops = plan.to_device("cuda")
    kw = plan.kernel_kwargs()
    got = oz(*ops, **kw)
    exp = ok.ozaki_strip_numeric_plain(*ops, **kw)
    torch.cuda.synchronize()
    err = max((g - e).abs().max().item() for g, e in zip(got, exp))
    check(all(torch.equal(g, e) for g, e in zip(got, exp)),
          f"the Ozaki kernel differs from its plain version on the main "
          f"plan: {err}")
    kept = sum(1 for i in range(plan.sa) for j in range(plan.sb)
               if i + j <= plan.pmax)
    macs = float(s.num_pairs) * kept * OZ_TM * s.tk * s.tn
    b_ms, b_by = bound(f"ozaki_strip (pairs {s.num_pairs} x {kept} kept "
                       f"slice products)", ops, got, [(2 * macs, "int8")])
    # the K-major copy of B the call writes first: bv8 and b_occ read
    # again and written once more
    copy_bytes = 2 * _nbytes((ops[2], ops[3]))
    bound_bytes("ozaki_strip with its K-major copy of B",
                _nbytes(ops) + _nbytes(got) + copy_bytes,
                [(2 * macs, "int8")])
    del got, exp
    a_t = _torch_csr(a, torch.float64)
    lib_ms = library_ms("torch.sparse.mm(A_csr, A_csr) f64 at the cant-like",
                        lambda: torch.sparse.mm(a_t, a_t), iters=3)
    del a_t
    ms = cuda_event_ms(lambda: oz(*ops, **kw), warmup=3, iters=30)
    split = kernel_split(lambda: oz(*ops, **kw))
    print(f"{CARD} | phase f64-strip-time: device ms by kernel "
          f"(torch.profiler): {split}")
    plain_ms = cuda_event_ms(lambda: ok.ozaki_strip_numeric_plain(*ops, **kw),
                             warmup=1, iters=5)
    gflops = 2.0 * nnz_cub / ((sym_ms + ms) * 1e6)
    tms = res.timings_ms
    print(f"phase f64-strip-time: symbolic_ms={sym_ms!r} kernel_ms={ms!r} "
          f"plain_ms={plain_ms!r} max_abs_err={err!r} f64 gflops={gflops!r} "
          f"(2*nnzCub/(symbolic+kernel); reference GPU bar 52.63)")
    print(f"phase f64-strip-time: spgemm_csr wall_s={csr_s!r} "
          f"symbolic_ms={tms['symbolic_ms']!r} prep_ms={tms['prep_ms']!r} "
          f"upload_ms={tms['upload_ms']!r} numeric_ms={tms['numeric_ms']!r} "
          f"(kernel + gather) compact_ms={tms['compact_ms']!r} (download + "
          f"host epilogue); peak device memory {csr_peak!r} bytes in "
          f"spgemm_csr, {torch.cuda.max_memory_allocated()!r} with the plain "
          f"version")
    return dict(name="ozaki_strip", route="cuda",
                source="spgemm_tpu_torch/csrc/ozaki_strip.cu",
                replaces="spgemm_tpu/ops/pallas_kernels.py:971",
                launches=launches[0], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def run_ozaki_passes_phase() -> None:
    """Phase 41: the auto f64 route's four hi/lo passes on the card
    against the CPU's plain run and the plain reference."""
    import torch

    from perfbench import reference
    from perfbench.matrices.top3d import Stiffness
    from spgemm_tpu_torch.models.csr import CSR
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr

    k = Stiffness({"nelx": 24, "nely": 8, "nelz": 4, "nu": 0.3,
                   "penal": 3.0, "E0": 1.0, "Emin": 1e-9})
    g = torch.Generator().manual_seed(2**31 + 11)
    a = CSR(k.indptr, k.indices, k.values(g, torch.float64).numpy(),
            k.shape)
    oz = ok.ozaki_strip_numeric
    _zero_counters(oz)
    t0 = time.perf_counter()
    gc, res = spgemm_csr(a, tm=TM, tn=TN, compute_dtype=torch.float64,
                         device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (oz.kernel_launches, oz.plain_launches)
    hc, _ = spgemm_csr(a, tm=TM, tn=TN, compute_dtype=torch.float64,
                       device="cpu")
    same = gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)
    ip, idx, val, mag = reference.spgemm(
        a.indptr, a.indices, a.data, a.indptr, a.indices, a.data, a.n,
        device="cuda")
    pat = (np.array_equal(ip.cpu().numpy(), gc.indptr)
           and np.array_equal(idx.cpu().numpy(), gc.indices))
    err = float((np.abs(gc.data - val.cpu().numpy())
                 / mag.cpu().numpy()).max()) if pat else float("inf")
    st, tms = res.stats, res.timings_ms
    slots = st["numblkC_candidate"] * TM * TN
    print(f"phase f64-passes: SIMP 24x8x4 n={a.m} nnz={a.nnz} "
          f"backend={st['backend']} passes={st['ozaki_passes']} "
          f"S={[(p.sa, p.sb, p.pmax) for p in res.schedule.passes]} "
          f"launches (kernel, plain)={launches} bit-equal to the CPU: "
          f"{same} pattern_equal={pat} max_scaled_err={err!r} (limit "
          f"1e-12) d2h_bytes={st['d2h_bytes']!r} candidate slots={slots!r} "
          f"wall_s={wall!r} " + " ".join(
              f"{k}={v:.3f}" for k, v in sorted(tms.items())))
    check(st["ozaki_passes"] == 4 and launches == (4, 0),
          f"the hi/lo passes did not run as four kernel launches: "
          f"{st['ozaki_passes']} passes, launches {launches}")
    check(same, "the hi/lo passes on the card differ from the CPU's")
    check(pat and err <= 1e-12,
          f"the hi/lo passes miss f64 entry by entry: {err!r}")
    check(st["d2h_bytes"] <= 16 * slots,
          f"d2h_bytes {st['d2h_bytes']} past 16 B a candidate slot")


TILE_FIELDS = ("trow", "tcol", "tptr", "tnnz_ptr", "rc", "val", "mask",
               "rowptr")


def _same_tilemat(x, y) -> bool:
    """Every TileMat field equal, dtype and all; values bit for bit."""
    return (x.shape, x.tm, x.tn) == (y.shape, y.tm, y.tn) and all(
        getattr(x, f).dtype == getattr(y, f).dtype
        and np.array_equal(getattr(x, f).view(np.uint8),
                           getattr(y, f).view(np.uint8))
        for f in TILE_FIELDS)


def run_pick_phase(mesh: dict | None = None, dev: str = "cuda") -> None:
    """Phase 42: C's entries picked on the card at the top3d.a2 cell's
    full mesh (`mesh` overrides its nelx, nely, nelz), f32 and f64,
    against the CPU's picking and the host assembly of the same
    planes."""
    import torch

    from perfbench.matrices.top3d import Stiffness
    from spgemm_tpu_torch.models.csr import CSR
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import gustavson as gu
    from spgemm_tpu_torch.ops import kernels
    from spgemm_tpu_torch.ops.ozaki import (build_ozaki_strip,
                                            ozaki_strip_passes_numeric)
    from spgemm_tpu_torch.ops.spgemm import _compact_to_tilemat, spgemm_csr

    with open("perfbench/configs/top3d.json") as f:
        k = Stiffness({**json.load(f), **(mesh or {})})
    for dtype in (torch.float32, torch.float64):
        f32 = dtype == torch.float32
        g = torch.Generator().manual_seed(2**31 + 17)
        a = CSR(k.indptr, k.indices, k.values(g, dtype).numpy(), k.shape)
        spgemm_csr(a, tm=TM, tn=TN, compute_dtype=dtype, device=dev)
        calls = gu.pick_tiles.device_calls
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, res = spgemm_csr(a, tm=TM, tn=TN, compute_dtype=dtype,
                            device=dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        st, tms, c = res.stats, res.timings_ms, res.c
        nt_c = int(st["numblkC_candidate"])
        picked = (nt_c + c.nnz * (4 + (4 if f32 else 8))
                  + c.nt * TM * (TN // 32) * 4 + c.nt * (TM + 1) * 4)
        planes = nt_c * TM * TN * ((4 + 4 / 32) if f32 else 9)
        print(f"{CARD} | phase pick: top3d {k.shape[0]} rows nnz="
              f"{a.nnz} {dtype} backend={st['backend']} nt_c={nt_c} "
              f"nt={c.nt} nnzC={c.nnz} d2h_bytes={st['d2h_bytes']!r} "
              f"(picked arrays {picked!r}; the dense planes' figure "
              f"{planes!r}) peak_device_bytes={peak!r} wall_s={wall!r} "
              + " ".join(f"{n}={v:.3f}" for n, v in sorted(tms.items())))
        check(gu.pick_tiles.device_calls == calls + 1,
              f"{dtype}: C's entries were not picked on the card")
        check(st["d2h_bytes"] == picked,
              f"{dtype}: d2h_bytes {st['d2h_bytes']} != {picked}")
        at, bt = csr_to_tiles(a, TM, TN), csr_to_tiles(a, TN, TN)
        if f32:
            sargs = gu.build_strip_args(at, bt)
            ops = sargs.to_device(dev)
            cv, cc = kernels.strip_numeric(*ops, **sargs.kernel_kwargs())
            del ops
            gidx = torch.from_numpy(sargs.gather_idx.astype(np.int64))
            v, occ = gu.strip_compact(cv, cc, gidx.to(dev))
            del cv, cc
        else:
            plan = build_ozaki_strip(at, bt, strict=True)
            sargs = plan.sargs
            (v, occ), _ = ozaki_strip_passes_numeric(plan, device=dev)
        where = (sargs.ctrow, sargs.ctcol, (a.m, a.n))
        on_card = gu.pick_tiles(v, occ).tilemat(*where)
        v, occ = v.cpu(), occ.cpu()
        t0 = time.perf_counter()
        on_cpu = gu.pick_tiles(v, occ).tilemat(*where)
        cpu_s = time.perf_counter() - t0
        occ = (gu.unpack_occ_words(occ.numpy(), TN) if f32
               else occ.numpy())
        t0 = time.perf_counter()
        host = _compact_to_tilemat(*where[:2], v.numpy(), occ, where[2],
                                   TM, TN)
        host_s = time.perf_counter() - t0
        del v, occ
        torch.cuda.empty_cache()
        same = (_same_tilemat(on_card, on_cpu), _same_tilemat(on_card, host))
        print(f"phase pick: {dtype} the route's planes picked on the card "
              f"== on the CPU: {same[0]} == the host assembly: {same[1]} "
              f"(CPU pick {cpu_s!r} s, host assembly {host_s!r} s); the "
              f"call's TileMat == the card's pick: "
              f"{_same_tilemat(c, on_card)}")
        check(all(same), f"{dtype}: the card's picked TileMat differs "
                         f"from the CPU's or the host assembly's: {same}")


def _close(got, exp, *, rtol=GAUSS_RTOL, atol_rel=1e-6):
    """(ok, max_abs_err, max|exp|) for f32 results summed in another
    order than their reference."""
    import torch

    got = torch.as_tensor(got).double().cpu()
    exp = torch.as_tensor(exp).double().cpu()
    scale = exp.abs().max().item() if exp.numel() else 0.0
    err = (got - exp).abs().max().item() if exp.numel() else 0.0
    ok = got.shape == exp.shape and torch.allclose(
        got, exp, rtol=rtol, atol=atol_rel * scale)
    return ok, err, scale


def _spmm_ops(t, x, width, block_rows):
    """The strip SpMM kernel's packed operands on the card and, at a
    narrow width, the sector map its narrow form reads A by."""
    import torch

    from spgemm_tpu_torch.ops import spmm as pspmm

    packed = pspmm._pack_spmm_operands(t, x, width, torch.float32,
                                       block_rows)
    return packed.to_device("cuda"), packed.sector_map_to("cuda")


def compare_spmm_plans() -> None:
    """Phase 13: the SpMM kernel against its plain version."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import spmm as pspmm
    from spgemm_tpu_torch.ops import spmm_kernels as smk
    from spgemm_tpu_torch.utils.generators import banded

    rng = np.random.default_rng(17)
    block_rows = 64
    for tm in (16, 64):
        for values in ("integer", "gaussian"):
            a = banded(rng, 6000, 64)
            if values == "gaussian":
                a = a.with_data(rng.standard_normal(a.nnz))
                x = rng.standard_normal((a.n, 200))
            else:
                x = rng.integers(-4, 5, (a.n, 200)).astype(np.float64)
            t = csr_to_tiles(a, tm, TN)
            stats = pspmm._spmm_block_stats(t, block_rows)
            kmin = torch.from_numpy(pspmm._window_kmin(t, stats)).to("cuda")
            # (k, packed width): the 128-column form and the narrow one
            for k, width in ((200, 256), (1, 1), (1, 8), (20, 32)):
                ops, smap = _spmm_ops(t, x[:, :k], width, block_rows)
                for form, km in (("resident", None), ("window", kmin)):
                    got = smk.spmm_strip(*ops, km, gm=t.gm,
                                         block_rows=block_rows, smap=smap)
                    exp = smk.spmm_strip_plain(*ops, km, gm=t.gm,
                                               block_rows=block_rows)
                    torch.cuda.synchronize()
                    if values == "integer":
                        ok, err, scale = torch.equal(got, exp), 0.0, 0.0
                        if not ok:
                            err = (got - exp).abs().max().item()
                    else:
                        ok, err, scale = _close(got, exp)
                    print(f"phase spmm-compare: tiles {tm}x{TN} {form} "
                          f"{values} rows={got.shape[0]} k={k} width={width} "
                          f"max_abs_err={err!r} max_abs={scale!r} ok={ok}")
                    check(ok, f"SpMM kernel differs from its plain version "
                              f"({tm}x{TN}, {form}, {values}, width "
                              f"{width}): {err}")


class _RouteSpy:
    """Records which of spmm's three routes each call takes."""

    NAMES = ("spmm_gather", "_spmm_strip", "_spmm_tiles")

    def __enter__(self):
        from spgemm_tpu_torch.ops import spmm as pspmm

        self.mod, self.saved, self.log = pspmm, {}, []
        for name in self.NAMES:
            fn = self.saved[name] = getattr(pspmm, name)

            def spy(*args, _fn=fn, _name=name, **kw):
                self.log.append(_name)
                return _fn(*args, **kw)

            setattr(pspmm, name, spy)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


def _sp(a):
    import scipy.sparse as sp

    return sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)


def run_spmm_path(suite: dict) -> list:
    """Phases 14 and 15: the SpMM path at banded65536 (resident and
    window form) and rmat65536 (gather), then the timings. Returns the
    kernels JSON entries of the two kernel forms."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import spmm as pspmm
    from spgemm_tpu_torch.ops import spmm_kernels as smk
    from spgemm_tpu_torch.ops.spmm import spmm, spmv
    from spgemm_tpu_torch.utils.timing import cuda_event_ms, profiler_device_ms

    w = smk.spmm_strip
    name = f"banded{SUITE_N}"
    a = suite[name]
    t = csr_to_tiles(a, SPMM_TM, TN)
    sa = _sp(a)
    rng = np.random.default_rng(41)
    print(f"phase spmm: {name} {a.m}x{a.n} nnz={a.nnz} tiles {SPMM_TM}x{TN} "
          f"nt={t.nt} gm={t.gm} gn={t.gn} L2 budget {pspmm.L2_BYTES} B")
    xs = {}
    launches = {}
    # (label, k, the kernel form _spmm_mode must pick, vector form)
    for label, k, form, vec in (("resident", SPMM_K, "resident", False),
                                ("spmv", 1, "resident", True),
                                ("window", 2 * SPMM_K, "window", False)):
        x = rng.standard_normal(a.n if vec else (a.n, k)).astype(np.float32)
        xs[label] = x
        k_pad = max(128, -(-k // 128) * 128)
        mode = pspmm._spmm_mode(t, k_pad, device=torch.device("cuda"))[0]
        check(mode == form, f"{label}: the gate picked {mode}, not {form}")
        _zero_counters(w)
        t0 = time.perf_counter()
        with _RouteSpy() as spy:
            y = (spmv if vec else spmm)(t, x, device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[label] = (w.kernel_launches, w.plain_launches)
        narrow = w.narrow_launches
        ok, err, scale = _close(y, sa @ x.astype(np.float64))
        print(f"phase spmm: {label} k={k} mode={mode} route={spy.log} "
              f"wall_s={wall!r} launches (kernel, plain)={launches[label]} "
              f"of them narrow form={narrow} (packed width "
              f"{smk.pack_width(k)}) max_abs_err={err!r} max|Y|={scale!r} "
              f"ok={ok}")
        check(spy.log == ["_spmm_strip"], f"{label} took route {spy.log}")
        check(launches[label][0] >= 1 and launches[label][1] == 0,
              f"the {label} SpMM did not run through the kernel: "
              f"{launches[label]}")
        check((narrow == launches[label][0]) == (k <= 32) and
              (narrow == 0) == (k > 32),
              f"the {label} SpMM ran the wrong kernel form: {narrow} narrow "
              f"launches of {launches[label][0]}")
        check(ok, f"{label} SpMM differs from scipy: {err}")
        del y

    gname = f"rmat{SUITE_N}"
    g = suite[gname]
    tg = csr_to_tiles(g, SPMM_TM, TN)
    xg = rng.standard_normal((g.n, SPMM_K)).astype(np.float32)
    _zero_counters(w)
    t0 = time.perf_counter()
    with _RouteSpy() as spy:
        y = spmm(tg, xg, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ok, err, scale = _close(y, _sp(g) @ xg.astype(np.float64))
    print(f"phase spmm: {gname} nnz={g.nnz} nt={tg.nt} k={SPMM_K} "
          f"route={spy.log} wall_s={wall!r} strip kernel launches "
          f"(kernel, plain)={(w.kernel_launches, w.plain_launches)} "
          f"max_abs_err={err!r} max|Y|={scale!r} ok={ok}")
    check(spy.log == ["spmm_gather"], f"{gname} took route {spy.log}")
    check(ok, f"{gname} gather SpMM differs from scipy: {err}")
    del y, tg

    # --- phase 15: timings ---------------------------------------------
    entries = []
    block_rows = 64
    stats = pspmm._spmm_block_stats(t, block_rows)
    a_t = _torch_csr(a, torch.float32)
    for label, entry_name, replaces in (
            ("resident", "spmm_strip", "spgemm_tpu/ops/pallas_kernels.py:679"),
            ("spmv", "spmm_strip_spmv", "spgemm_tpu/ops/pallas_kernels.py:679"),
            ("window", "spmm_strip_window",
             "spgemm_tpu/ops/pallas_kernels.py:805")):
        x = xs[label]
        x2 = x[:, None] if x.ndim == 1 else x
        k = x2.shape[1]
        ops, smap = _spmm_ops(t, x2, smk.pack_width(k), block_rows)
        km = (None if label != "window" else
              torch.from_numpy(pspmm._window_kmin(t, stats)).to("cuda"))
        kw = dict(gm=t.gm, block_rows=block_rows)
        got = w(*ops, km, **kw, smap=smap)
        exp = smk.spmm_strip_plain(*ops, km, **kw)
        torch.cuda.synchronize()
        ok, err, _ = _close(got, exp)
        check(ok, f"SpMM kernel differs from its plain version ({label}, "
                  f"{name}): {err}")
        width = got.shape[2]
        if x.ndim == 1:
            b_ms, b_by = spmv_bound(f"spmm {label} k={k}", t, ops, smap, got)
        else:
            b_ms, b_by = bound(
                f"spmm {label} k={k} width={width}", (*ops, km), (got,),
                _f32_mma_ops(float(t.nt) * t.tm * t.tn * width))
        del got, exp
        kw["smap"] = smap
        ms = cuda_event_ms(lambda: w(*ops, km, **kw), warmup=3, iters=20)
        plain_ms = cuda_event_ms(lambda: smk.spmm_strip_plain(*ops, km, **kw),
                                 warmup=1, iters=20)
        xd = torch.from_numpy(x).to("cuda")
        if x.ndim == 1:
            lib_ms = library_ms(f"torch.mv(A_csr, x) f32 at {name}",
                                lambda: torch.mv(a_t, xd), iters=20)
        else:
            lib_ms = library_ms(f"torch.sparse.mm(A_csr, X) f32 k={k} at "
                                f"{name}", lambda: torch.sparse.mm(a_t, xd),
                                iters=20)
        dev_ms = profiler_device_ms(lambda: w(*ops, km, **kw))
        extra = {}
        if x.ndim == 2:
            extra = _spmm_integer_x_time(label, t, k, width, block_rows, km,
                                         kw, rng)
        lib_dev_ms = None
        if lib_ms is not None:
            lib_dev_ms = profiler_device_ms(
                (lambda: torch.mv(a_t, xd)) if x.ndim == 1
                else (lambda: torch.sparse.mm(a_t, xd)))
        flushed = {}
        if x.ndim == 1:
            # the SpMV row's rank: both calls with L2 flushed before each
            # timed call (a 64 MiB write outside the event pair)
            flushed["l2_flushed_ms"] = cuda_event_ms(
                lambda: w(*ops, km, **kw), warmup=3, iters=20, flush_l2=True)
            flushed["library_l2_flushed_ms"] = (None if lib_ms is None else
                                                cuda_event_ms(
                lambda: torch.mv(a_t, xd), warmup=3, iters=20,
                flush_l2=True))
            print(f"{CARD} | phase spmm-time: spmv with L2 flushed before "
                  f"each call: kernel_ms={flushed['l2_flushed_ms']!r} "
                  f"torch.mv ms={flushed['library_l2_flushed_ms']!r} "
                  f"(CUDA events)")
        del xd
        print(f"phase spmm-time: {label} k={k} width={width} kernel_ms={ms!r} "
              f"plain_ms={plain_ms!r} library_ms={lib_ms!r} (CUDA events "
              f"around each call); profiled device time: kernel "
              f"{dev_ms!r} ms, library call {lib_dev_ms!r} ms")
        print(f"phase spmm-time: {label} "
              f"max_abs_err={err!r} GFLOPS="
              f"{2.0 * a.nnz * k / (ms * 1e6)!r} (2*nnz*k / kernel ms) "
              f"dense-tile GFLOPS={2.0 * t.nt * t.tm * t.tn * width / (ms * 1e6)!r}")
        entries.append(dict(
            name=entry_name, route="cuda",
            source="spgemm_tpu_torch/csrc/spmm_strip.cu", replaces=replaces,
            launches=launches[label][0], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, device_ms=dev_ms,
            library_device_ms=lib_dev_ms, **flushed, **extra))
        del ops
    del a_t
    gms = pspmm.time_spmm_gather(g, xg, warmup=2, iters=20, device="cuda")
    print(f"phase spmm-time: gather {gname} k={SPMM_K} device_ms={gms!r} "
          f"GFLOPS={2.0 * g.nnz * SPMM_K / (gms * 1e6)!r} (2*nnz*k / ms)")
    torch.cuda.empty_cache()
    return entries


def _spmm_integer_x_time(label, t, k, width, block_rows, km, kw,
                         rng) -> dict:
    """The 128-column SpMM form on the same tiles with integer X (the
    suite's A is integer: one tensor-core product a k8 step), bit-equal to
    its plain version, timed by CUDA events and torch.profiler:
    {"integer_ms", "integer_device_ms"}."""
    import torch

    from spgemm_tpu_torch.ops import spmm_kernels as smk
    from spgemm_tpu_torch.utils.timing import cuda_event_ms, profiler_device_ms

    w = smk.spmm_strip
    xi = rng.integers(-4, 5, (t.n, k)).astype(np.float32)
    ops, _ = _spmm_ops(t, xi, width, block_rows)
    got = w(*ops, km, **kw)
    exp = smk.spmm_strip_plain(*ops, km, gm=kw["gm"],
                               block_rows=kw["block_rows"])
    torch.cuda.synchronize()
    check(torch.equal(got, exp), f"SpMM kernel differs from its plain "
                                 f"version on integer X ({label})")
    del got, exp
    ms = cuda_event_ms(lambda: w(*ops, km, **kw), warmup=3, iters=20)
    dev = profiler_device_ms(lambda: w(*ops, km, **kw))
    print(f"{CARD} | phase spmm-time: {label} k={k} integer X: "
          f"kernel_ms={ms!r} device_ms={dev!r} (bit-equal to the plain "
          f"version)")
    return {"integer_ms": ms, "integer_device_ms": dev}


def _pair_operands(at, bt, sched, device, occ=None):
    """The pair kernel's operands; the occupancy planes in `occ` (float32,
    the reference's contract, unless given: the main path uploads
    bfloat16)."""
    import torch

    occ = occ or torch.float32
    up = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return (up(at.dense(np.float32)), up(at.occ()).to(occ),
            up(bt.dense(np.float32)), up(bt.occ()).to(occ), up(sched.pa),
            up(sched.pb), up(sched.pair_ptr))


def compare_pair_plans() -> None:
    """Phase 16: the pair kernel against its plain version."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import pair_kernels as pk
    from spgemm_tpu_torch.ops.symbolic import build_pair_schedule
    from spgemm_tpu_torch.utils.generators import banded

    rng = np.random.default_rng(19)
    for tm in (16, 64):
        for values in ("integer", "gaussian"):
            a = banded(rng, 6000, 64)
            if values == "gaussian":
                a = a.with_data(rng.standard_normal(a.nnz))
            at, bt = csr_to_tiles(a, tm, TN), csr_to_tiles(a, TN, TN)
            sched = build_pair_schedule(at, bt)
            for occ in (torch.float32, torch.bfloat16):
                ops = _pair_operands(at, bt, sched, "cuda", occ)
                gv, gc = pk.pair_accumulate_cuda(*ops,
                                                 num_segments=sched.nt_c)
                pv, pc = pk.pair_accumulate_plain(*ops,
                                                  num_segments=sched.nt_c)
                torch.cuda.synchronize()
                if values == "integer":
                    ok = torch.equal(gv, pv)
                    err = (gv - pv).abs().max().item()
                else:
                    ok, err, _ = _close(gv, pv)
                counts = torch.equal(gc > 0, pc > 0)
                print(f"phase pair-compare: tiles {tm}x{TN} {values} "
                      f"occupancy {occ} C tiles={sched.nt_c} "
                      f"pairs={sched.num_pairs} max_abs_err={err!r} "
                      f"values_ok={ok} counts_equal={counts}")
                check(ok and counts, f"pair kernel differs from its plain "
                                     f"version ({tm}x{TN}, {values}, {occ}): "
                                     f"{err}")


def run_pair_path(a, ref, lib_ms) -> dict:
    """Phase 17: the pair backends on the cant-like A^2, then the pair
    kernel's timing. `lib_ms` is torch.sparse.mm's time for the same
    product (the strip kernel's yardstick). Returns its kernels JSON
    entry."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import pair_kernels as pk
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr
    from spgemm_tpu_torch.utils.timing import cuda_event_ms, profiler_device_ms

    w = pk.pair_accumulate_cuda
    torch.cuda.empty_cache()
    pallas_launches = None
    for backend in ("pallas", "xla"):
        _zero_counters(w)
        t0 = time.perf_counter()
        c, res = spgemm_csr(a, tm=TM, tn=TN, backend=backend, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (w.kernel_launches, w.plain_launches)
        tms = res.timings_ms
        print(f"phase pair: cant-like {ROWS}x{ROWS} backend="
              f"{res.stats['backend']} C tiles={res.stats['numblkC_candidate']:.0f} "
              f"pairs={res.stats['num_pairs']:.0f} wall_s={wall!r} "
              f"symbolic_ms={tms['symbolic_ms']!r} upload_ms={tms['upload_ms']!r} "
              f"numeric_ms={tms['numeric_ms']!r} compact_ms={tms['compact_ms']!r} "
              f"pair kernel launches (kernel, plain)={launches}")
        check(res.stats["backend"] == backend, "pair backend not taken")
        if backend == "pallas":
            pallas_launches = launches[0]
            sched = res.schedule
            check(launches[0] >= 1 and launches[1] == 0,
                  f"backend=pallas did not run the pair kernel: {launches}")
        else:
            check(launches == (0, 0), f"backend=xla ran the pair kernel: "
                                      f"{launches}")
        _check_exact(f"spgemm_csr(backend={backend})", c, ref)
        del c, res

    at, bt = csr_to_tiles(a, TM, TN), csr_to_tiles(a, TN, TN)
    # the bound counts the operands of the timed call: the bf16 occupancy
    # that the main path uploads; bound_ref_ms counts the reference's f32
    # planes instead, for comparison with kernels that read those
    ref_ops = _pair_operands(at, bt, sched, "cuda")
    ops = _pair_operands(at, bt, sched, "cuda", torch.bfloat16)
    kw = dict(num_segments=sched.nt_c)
    gv, gc = w(*ops, **kw)
    pv, pc = pk.pair_accumulate_plain(*ops, **kw)
    torch.cuda.synchronize()
    err = (gv - pv).abs().max().item()
    check(torch.equal(gv, pv) and torch.equal(gc > 0, pc > 0),
          f"the pair kernel differs from its plain version on the cant-like "
          f"schedule: {err}")
    tm, tk = ops[0].shape[1:]
    products = float(sched.num_pairs) * tm * tk * TN
    pair_ops = _f32_mma_ops(products) + [(2 * products, "bf16")]
    b_ms, b_by = bound("pair_accumulate (values and counts, bf16 occupancy)",
                       ops, (gv, gc), pair_ops)
    ref_ms, _ = bound("pair_accumulate (values and counts, f32 occupancy: "
                      "bound_ref_ms)", ref_ops, (gv, gc), pair_ops)
    del gv, gc, pv, pc, ref_ops
    ms = cuda_event_ms(lambda: w(*ops, **kw), warmup=3, iters=20)
    dev_ms = profiler_device_ms(lambda: w(*ops, **kw))
    plain_ms = cuda_event_ms(lambda: pk.pair_accumulate_plain(*ops, **kw),
                             warmup=1, iters=10)
    flop = 2.0 * 2 * sched.num_pairs * tm * tk * TN  # values and counts
    print(f"{CARD} | phase pair-time: kernel_ms={ms!r} device_ms={dev_ms!r} "
          f"bound_ms={b_ms!r} ({100.0 * b_ms / ms!r}% of the kernel's time) "
          f"plain_ms={plain_ms!r} "
          f"max_abs_err={err!r} dense-tile TFLOP/s={flop / (ms * 1e9)!r} "
          f"(values and counts, {flop!r} FLOP); peak device memory "
          f"{torch.cuda.max_memory_allocated()!r} bytes")
    del ops
    # the same schedule with standard-normal values: every k step takes
    # the exact three-way split
    ag = a.with_data(np.random.default_rng(0).standard_normal(a.nnz))
    g_ops = _pair_operands(csr_to_tiles(ag, TM, TN), csr_to_tiles(ag, TN, TN),
                           sched, "cuda", torch.bfloat16)
    gv, gc = w(*g_ops, **kw)
    pv, pc = pk.pair_accumulate_plain(*g_ops, **kw)
    torch.cuda.synchronize()
    g_ok, g_err, g_scale = _close(gv, pv)
    g_cnt = torch.equal(gc, pc)
    del gv, gc, pv, pc
    check(g_ok and g_cnt, f"the pair kernel differs from its plain version "
                          f"on Gaussian values: {g_err}, counts {g_cnt}")
    g_ms = cuda_event_ms(lambda: w(*g_ops, **kw), warmup=3, iters=20)
    g_dev_ms = profiler_device_ms(lambda: w(*g_ops, **kw))
    print(f"{CARD} | phase pair-time: Gaussian values kernel_ms={g_ms!r} "
          f"device_ms={g_dev_ms!r} max_abs_err={g_err!r} "
          f"max_abs={g_scale!r}, counts equal")
    del g_ops
    return dict(name="pair_accumulate", route="cuda",
                source="spgemm_tpu_torch/csrc/pair_accumulate.cu",
                replaces="spgemm_tpu/ops/pallas_kernels.py:32",
                launches=pallas_launches, max_abs_err=err, ms=ms,
                device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, bound_ref_ms=ref_ms, library_ms=lib_ms,
                gaussian_ms=g_ms, gaussian_device_ms=g_dev_ms,
                gaussian_max_abs_err=g_err)


# --- the tiled routes without a hand kernel ----------------------------------
SLAB_T = 16                     # TileSpGEMM's own tile (SURVEY.md): 16x16
CUT_ROWS = 4096                 # the f64 slab cut held bit-equal to the CPU
CARD = ""                       # nvidia-smi's name and power limit line


def _all_wrappers():
    from spgemm_tpu_torch.ops import (gather_kernels, kernels, ozaki_kernels,
                                      pair_kernels, scan_kernels,
                                      spmm_kernels)

    return (kernels.strip_numeric, scan_kernels.esc_scan,
            scan_kernels.esc_scan_mul, scan_kernels.esc_scan_dd,
            ozaki_kernels.ozaki_strip_numeric, spmm_kernels.spmm_strip,
            pair_kernels.pair_accumulate_cuda,
            gather_kernels.take_along_blocks)


def _check_no_kernel(label: str) -> None:
    """No hand kernel and no plain kernel version ran since the counters
    were zeroed: the route is torch ops end to end."""
    ran = {w.__name__: (w.kernel_launches, w.plain_launches)
           for w in _all_wrappers() if w.kernel_launches or w.plain_launches}
    print(f"phase check: {label} hand-kernel launches (kernel, plain) since "
          f"zeroed: {ran or 'none'}")
    check(not ran, f"{label} ran a hand kernel or a plain version: {ran}")


def _route(label: str, call):
    """Counters zeroed, then `call` (an entry point) with its wall time;
    checks that no kernel ran. Returns (C, result, wall_s)."""
    import torch

    _zero_counters(*_all_wrappers())
    t0 = time.perf_counter()
    c, res = call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"phase {label}: backend={res.stats['backend']} wall_s={wall!r} "
          f"timings_ms={res.timings_ms} stats={res.stats}")
    _check_no_kernel(label)
    return c, res, wall


def _check_close(label, got, ref, *, rtol, atol_rel) -> None:
    from spgemm_tpu_torch.ops import golden

    got = golden.drop_explicit_zeros(got)
    pat = got.pattern_equal(ref)
    scale = float(np.abs(ref.data).max()) if ref.nnz else 0.0
    err = float(np.abs(got.data - ref.data).max()) if pat and ref.nnz \
        else (0.0 if pat else float("inf"))
    ok = pat and np.allclose(got.data, ref.data, rtol=rtol,
                             atol=atol_rel * scale)
    print(f"phase check: {label} nnzC={got.nnz} oracle nnzC={ref.nnz} "
          f"pattern_equal={pat} max_abs_err={err!r} max|C|={scale!r} "
          f"(rtol {rtol}, atol {atol_rel}*max|C|)")
    check(ok, f"{label} result differs from the scipy oracle")


def op_split(fn, *, iters: int = 3) -> dict:
    """Device milliseconds per call of `fn` by the aten op that launched
    the work (torch.profiler, self device time): bmm, copy_ (permutes and
    casts), index_add_, add/sub/mul (sums and the TwoSum combine)..."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        # aten ops only: the profiler's own buffer events carry device time
        if (e.device_type == DeviceType.CPU and e.key.startswith("aten::")
                and e.self_device_time_total > 0):
            split[e.key] = e.self_device_time_total / iters / 1e3
    return dict(sorted(split.items(), key=lambda kv: -kv[1]))


def kernel_split(fn, *, iters: int = 10) -> dict:
    """Device milliseconds per call of `fn` by CUDA kernel
    (torch.profiler), for a wrapper that launches more than one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "").split("(")[0]:
            e.self_device_time_total / iters / 1e3
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _time_lines(label, res, wall, numeric_ms, split, moved, bnd, lib_ms,
                nnz_cub, sym_ms) -> None:
    """The route's timing lines, each led by the card's name and limit.
    `moved` is the bytes of the numeric step's inputs and outputs, `bnd`
    its (bound_ms, bound_by) from bound()."""
    tms = res.timings_ms
    total = sum(split.values())
    shares = ", ".join(f"{k} {v!r} ms ({v / total:.1%})"
                       for k, v in split.items()) if total else "none"
    print(f"{CARD} | phase {label}-time: symbolic_ms={sym_ms!r} "
          f"prep_ms={tms.get('prep_ms', 0.0)!r} "
          f"upload_ms={tms['upload_ms']!r} numeric_ms={numeric_ms!r} "
          f"(CUDA events, median) in-call numeric_ms={tms['numeric_ms']!r}")
    print(f"{CARD} | phase {label}-time: device split per call (torch."
          f"profiler, self device time by op): {shares}; sum {total!r} ms")
    print(f"{CARD} | phase {label}-time: compact_ms={tms['compact_ms']!r} "
          f"wall_s={wall!r}")
    bytes_ms = _h100().bound(moved)[0]
    print(f"{CARD} | phase {label}-time: numeric bytes={moved} (inputs read "
          f"once, outputs written once) -> {bytes_ms!r} ms at 3.35 TB/s; "
          f"bound_ms={bnd[0]!r} (by {bnd[1]}, the products at their type's "
          f"peak); share {bnd[0] / numeric_ms:.1%}")
    print(f"{CARD} | phase {label}-time: library_ms={lib_ms!r} "
          f"(torch.sparse.mm on the same product)")
    gflops = 2.0 * nnz_cub / ((sym_ms + numeric_ms) * 1e6)
    print(f"{CARD} | phase {label}-time: GFLOPS={gflops!r} "
          f"(2*nnzCub/(symbolic+numeric), nnzCub={nnz_cub})")


def run_gustavson_route(a, ref):
    """Phase 18: the slab route. The cant-like A^2 at 16x16 through
    spgemm_csr: auto must pick gustavson, C equal to scipy exactly on the
    integer model, also A*A^T; standard-normal values through
    backend="strip" fall back to it, within rtol 1e-5. Then its timings.
    Returns (Gaussian A, its scipy A^2) for the f64 phases."""
    import torch

    from spgemm_tpu_torch.models.csr import flop_count_spgemm
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.ops.gustavson import (build_gustavson_plan,
                                                gustavson_numeric)
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr
    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    torch.cuda.empty_cache()
    c, res, wall = _route("gustavson", lambda: spgemm_csr(
        a, tm=SLAB_T, tn=SLAB_T, device="cuda"))
    plan = res.schedule
    print(f"phase gustavson: cant-like {ROWS}x{ROWS} tiles {SLAB_T}x{SLAB_T} "
          f"gk={plan.gk} max_a={plan.max_a} max_b={plan.max_b} "
          f"pairs={plan.num_pairs} slots={plan.gk * plan.max_a * plan.max_b} "
          f"padding_ratio={plan.padding_ratio()!r} nt_c={plan.nt_c}")
    check(res.stats["backend"] == "gustavson",
          f"auto routing picked {res.stats['backend']} at 16x16")
    _check_exact("gustavson integer", c, ref)
    del c
    ct, rest, _ = _route("gustavson-aat", lambda: spgemm_csr(
        a, tm=SLAB_T, tn=SLAB_T, aat=True, device="cuda"))
    check(rest.stats["backend"] == "gustavson", "aat did not run gustavson")
    _check_exact("gustavson aat integer", ct, golden.spgemm_scipy(
        a, a.transpose()))
    del ct
    ag = a.with_data(np.random.default_rng(0).standard_normal(a.nnz))
    cg, resg, _ = _route("gustavson-strip-fallback", lambda: spgemm_csr(
        ag, tm=SLAB_T, tn=SLAB_T, backend="strip", device="cuda"))
    check(resg.stats["backend"].startswith("gustavson(strip-fallback: "),
          f"backend='strip' at 16x16 reported {resg.stats['backend']}")
    ref_g = golden.spgemm_scipy(ag, ag)
    _check_close("gustavson Gaussian", cg, ref_g, rtol=GAUSS_RTOL,
                 atol_rel=1e-6)
    del cg

    at = csr_to_tiles(a, SLAB_T, SLAB_T)
    sym_ms = float("inf")
    for _ in range(3):
        sym_ms = min(sym_ms, build_gustavson_plan(at, at).symbolic_ms)
    ops = plan.to_device("cuda")
    kw = plan.numeric_kwargs()
    step = lambda: gustavson_numeric(*ops, **kw)
    ms = cuda_event_ms(step, warmup=2, iters=10)
    split = op_split(step)
    out = step()
    moved = _nbytes(ops) + _nbytes(out)
    # two full-FP32 slab products (values, counts) over every padded slot
    flops = 2 * 2.0 * plan.gk * plan.max_a * plan.max_b * SLAB_T ** 3
    bnd = bound("gustavson numeric", ops, out, [(flops, "f32")])
    del out
    a_t = _torch_csr(a, torch.float32)
    lib = library_ms("torch.sparse.mm(A_csr, A_csr) f32 at the cant-like "
                     "(gustavson)", lambda: torch.sparse.mm(a_t, a_t),
                     iters=3)
    del a_t, ops
    _time_lines("gustavson", res, wall, ms, split, moved, bnd, lib,
                flop_count_spgemm(a, a), sym_ms)
    return ag, ref_g


def run_dense_route():
    """Phase 19: the dense route. The suite's banded8192 A^2 at 16x16
    through spgemm_csr: auto must pick dense, C equal to scipy exactly;
    a cancelling product keeps its stored zero. Then its timings."""
    import torch

    from spgemm_tpu_torch.models.csr import CSR, flop_count_spgemm
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr, time_dense
    from spgemm_tpu_torch.ops.spgemm import _dense_operands, _dense_step
    from spgemm_tpu_torch.utils import generators as pgen

    torch.cuda.empty_cache()
    b8 = pgen.suite(8192)["banded8192"]
    c, res, wall = _route("dense", lambda: spgemm_csr(
        b8, tm=SLAB_T, tn=SLAB_T, device="cuda"))
    print(f"phase dense: banded8192 nnz={b8.nnz} tiles {SLAB_T}x{SLAB_T} "
          f"C tiles={res.stats['numblkC']:.0f}")
    check(res.stats["backend"] == "dense",
          f"auto routing picked {res.stats['backend']} for banded8192")
    _check_exact("dense integer", c, golden.spgemm_scipy(b8, b8))
    del c
    za = CSR.from_dense(np.array([[1.0, -1.0], [0.0, 2.0]]))
    zb = CSR.from_dense(np.array([[1.0, 0.0], [1.0, 0.0]]))
    zc, zres = spgemm_csr(za, zb, tm=2, tn=2, backend="dense", device="cuda")
    print(f"phase dense: cancelling product backend={zres.stats['backend']} "
          f"indices={zc.indices.tolist()} data={zc.data.tolist()}")
    check(zc.indices.tolist() == [0, 0] and zc.data.tolist() == [0.0, 2.0],
          "the dense route lost a structural zero")

    at = csr_to_tiles(b8, SLAB_T, SLAB_T)
    ms = time_dense(at, at, device="cuda", warmup=2, iters=10)
    ops = _dense_operands(at, at, np.float32, "cuda")
    kw = dict(gm=at.gm, gn=at.gn, tm=SLAB_T, tn=SLAB_T)
    split = op_split(lambda: _dense_step(*ops, **kw))
    cv4, cc4, occ = _dense_step(*ops, **kw)
    moved = _nbytes(ops) + _nbytes((cv4, cc4, occ))
    mkn = 2.0 * (at.gm * SLAB_T) * (at.gn * SLAB_T) ** 2
    bnd = bound("dense step", ops, (cv4, cc4, occ),
                [(mkn, "f32"), (mkn, "bf16")])
    del cv4, cc4, occ, ops
    b_t = _torch_csr(b8, torch.float32)
    lib = library_ms("torch.sparse.mm(A_csr, A_csr) f32 at banded8192",
                     lambda: torch.sparse.mm(b_t, b_t), iters=5)
    del b_t
    _time_lines("dense", res, wall, ms, split, moved, bnd, lib,
                flop_count_spgemm(b8, b8), 0.0)


def _arrow(n: int = 4096):
    """One dense tile-row spanning every k: no windowed strip plan."""
    from spgemm_tpu_torch.models.csr import CSR

    r = np.concatenate([np.zeros(n // 8, np.int64), np.arange(n)])
    c = np.concatenate([np.arange(0, n, 8), np.arange(n)])
    return CSR.from_coo(r, c, ((r + c) % 7 + 1) + 0.5, (n, n))


def run_slab_f64_route(ag, ref_g):
    """Phases 20 and 21: the f64 slab engine on the cant-like A^2 with
    standard-normal values at 16x16 (no Ozaki kernel for these tiles):
    within 1e-12*max|C| of scipy, and bit-equal to the CPU's ozaki_core
    on a cut; the arrow pattern through backend="ozaki"; then
    OzakiExecutor on the same plan and its timings."""
    import torch

    from spgemm_tpu_torch.models.csr import CSR, flop_count_spgemm
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.ops.executor import OzakiExecutor
    from spgemm_tpu_torch.ops.ozaki import (build_ozaki_plan, ozaki_compact,
                                            ozaki_core)
    from spgemm_tpu_torch.ops.spgemm import spgemm, spgemm_csr

    torch.cuda.empty_cache()
    c, res, wall = _route("f64-slab", lambda: spgemm_csr(
        ag, tm=SLAB_T, tn=SLAB_T, compute_dtype=torch.float64,
        device="cuda"))
    plan = res.schedule
    base = plan.base
    print(f"phase f64-slab: cant-like Gaussian tiles {SLAB_T}x{SLAB_T} "
          f"S={plan.sa}x{plan.sb} gk={base.gk} max_a={base.max_a} "
          f"max_b={base.max_b} pairs={base.num_pairs} nt_c={base.nt_c} "
          f"a_sl={plan.a_sl.shape} b_sl={plan.b_sl.shape}")
    check(res.stats["backend"] == "ozaki(S=8x8)(xla-fallback)",
          f"f64 at 16x16 ran {res.stats['backend']}")
    _check_close("f64 slab", c, ref_g, rtol=0.0, atol_rel=OZ_RTOL)
    del c

    # bit-equal to the CPU on a cut small enough for the host
    keep = ag.indptr[CUT_ROWS]
    cols = ag.indices[:keep]
    rows = ag.rows_expanded()[:keep]
    inside = cols < CUT_ROWS
    cut = CSR.from_coo(rows[inside], cols[inside], ag.data[:keep][inside],
                       (CUT_ROWS, CUT_ROWS))
    ct = csr_to_tiles(cut, SLAB_T, SLAB_T)
    cplan = build_ozaki_plan(ct, ct)
    on_cpu = ozaki_core(*cplan.to_device("cpu"), **cplan.core_kwargs())
    on_card = ozaki_core(*cplan.to_device("cuda"), **cplan.core_kwargs())
    same = [torch.equal(x, y.cpu()) for x, y in zip(on_cpu, on_card)]
    print(f"phase f64-slab: cut {CUT_ROWS}x{CUT_ROWS} nnz={cut.nnz} "
          f"S={cplan.sa}x{cplan.sb} nt_c={cplan.nt_c}: (h, m, l, cnt) "
          f"bit-equal to the CPU's ozaki_core: {same}")
    check(all(same), "the slab engine on the card differs from the CPU")
    del on_card

    arrow = _arrow()
    aat_, abt = csr_to_tiles(arrow, 32, TN), csr_to_tiles(arrow, TN, TN)
    _zero_counters(*_all_wrappers())
    ares = spgemm(aat_, abt, backend="ozaki", device="cuda")
    print(f"phase f64-slab: arrow {arrow.m}x{arrow.n} 32x{TN} "
          f"backend={ares.stats['backend']}")
    _check_no_kernel("f64-slab arrow")
    check(ares.stats["backend"].endswith("(xla-fallback)"),
          f"the arrow pattern ran {ares.stats['backend']}")
    _check_close("f64 slab arrow", ares.c.to_csr(),
                 golden.spgemm_scipy(arrow, arrow), rtol=0.0,
                 atol_rel=OZ_RTOL)

    # phase 21: OzakiExecutor on the phase-20 plan
    at = csr_to_tiles(ag, SLAB_T, SLAB_T)
    _zero_counters(*_all_wrappers())
    ex = OzakiExecutor(plan, at, at, device="cuda")
    out = ex.run()
    cube = ex.assemble(out)
    occ = out[3].cpu().numpy() > 0
    kept = occ.any(axis=(1, 2))
    vals = cube[kept][occ[kept]]
    one_pass = spgemm(at, at, backend="ozaki", device="cuda").c
    same = np.array_equal(vals, one_pass.val)
    print(f"phase ozaki-executor: run+assemble values={vals.size} equal to "
          f"the one-pass f64-slab C: {same}")
    check(same, "OzakiExecutor's run+assemble differs from the one-pass "
          "slab engine's C")
    del one_pass
    ag2 = ag.with_data(np.random.default_rng(1).standard_normal(ag.nnz))
    at2 = csr_to_tiles(ag2, SLAB_T, SLAB_T)
    ex.update_values(at2, at2)
    c2 = ozaki_compact(plan, *ex.run(), (ag.m, ag.n)).to_csr()
    _check_no_kernel("ozaki-executor")
    _check_close("ozaki-executor update_values", c2,
                 golden.spgemm_scipy(ag2, ag2), rtol=0.0, atol_rel=OZ_RTOL)
    del c2, out, cube

    # timings at the phase-20 plan (the executor holds it on the card)
    ms = ex.time_numeric(warmup=2, iters=10)
    split = op_split(lambda: ex.run(sync=False))
    out = ex.run()
    ops = [torch.from_numpy(x) for x in (plan.a_sl, plan.b_sl, plan.a_occ,
                                         plan.b_occ, base.seg)]
    moved = _nbytes(ops) + _nbytes(out)
    # Sa*Sb slice products and the count product, each an f32 slab bmm
    flops = (plan.sa * plan.sb + 1) * 2.0 * base.gk * base.max_a \
        * base.max_b * SLAB_T ** 3
    bnd = bound("f64 slab numeric", ops, out, [(flops, "f32")])
    del out, ops
    a_t = _torch_csr(ag, torch.float64)
    lib = library_ms("torch.sparse.mm(A_csr, A_csr) f64 at the cant-like "
                     "(slab)", lambda: torch.sparse.mm(a_t, a_t), iters=3)
    del a_t, ex
    _time_lines("f64-slab", res, wall, ms, split, moved, bnd, lib,
                flop_count_spgemm(ag, ag), res.timings_ms["symbolic_ms"])


# --- phases 22-29: the ESC digit mode and the example applications ----------
DEV = "cuda"                    # every phase below runs on the card
TRI_N, TRI_DEG = 262144, 16     # triangle_counting.random_graph: ~4.2 M edges
AMG_G, AMG_LEVELS = 1024, 2     # 1,048,576-unknown 5-point Poisson
MCL_N = 8192                    # markov_clustering, 12 iterations
PR_N, PR_DEG = 65536, 16        # pagerank's rmat(default_rng(7), ...)
PM_N, PM_BAND, PM_ITERS = 1 << 20, 8, 150  # power_method: ~17.8 M nnz
# serving_loop: cut from 65,536. Its strip ticks are checked at rtol
# 1e-4 and an absolute 1e-6, which f32 sums of 33 Gaussian products miss
# on a few near-zero entries by chance; scipy's own f32 product misses it
# at 65,536 (printed by the phase), and so did one tick of the strip
# kernel at 65,536 and at 8,192, none at 16,384
SERVE_N, SERVE_TICKS, SERVE_FULL_N = 16384, 3, 65536


def _counts() -> dict:
    return {w.__name__: (w.kernel_launches, w.plain_launches)
            for w in _all_wrappers()}


def _launched(label: str, required=()) -> None:
    """Prints which hand kernels launched since the counters were zeroed;
    fails if a plain version ran or a `required` kernel did not launch."""
    ran = {k: v for k, v in _counts().items() if v != (0, 0)}
    print(f"phase check: {label} hand-kernel launches (kernel, plain) since "
          f"zeroed: {ran or 'none'}")
    plain = {k: v for k, v in ran.items() if v[1]}
    check(not plain, f"{label} ran a plain version: {plain}")
    missing = [w.__name__ for w in required if w.kernel_launches == 0]
    check(not missing, f"{label} did not launch {missing}")


def _route_kernel(backend: str):
    """The hand kernel of an f32 spgemm_csr route (None: torch ops only:
    dense, gustavson, xla)."""
    from spgemm_tpu_torch.ops import kernels, scan_kernels

    return {"strip": kernels.strip_numeric,
            "esc": scan_kernels.esc_scan}.get(backend.split("(")[0])


class _CsrSpy:
    """Wraps an example module's spgemm_csr: per call the route, its wall
    time and the hand-kernel launches during it; keep=True also keeps A
    and C for the oracle."""

    def __init__(self, mod, keep: bool = False):
        self.mod, self.keep, self.calls = mod, keep, []

    def __enter__(self):
        import torch

        self.saved = self.mod.spgemm_csr

        def spy(*args, **kw):
            before = _counts()
            t0 = time.perf_counter()
            c, res = self.saved(*args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            delta = {k: (v[0] - before[k][0], v[1] - before[k][1])
                     for k, v in _counts().items() if v != before[k]}
            self.calls.append(dict(
                backend=res.stats["backend"], wall=wall, delta=delta,
                a=args[0] if self.keep else None, c=c if self.keep else None))
            return c, res

        self.mod.spgemm_csr = spy
        return self

    def __exit__(self, *exc):
        self.mod.spgemm_csr = self.saved

    def check(self, label: str) -> None:
        """Each call's route launched its hand kernel (where it has one)."""
        for i, call in enumerate(self.calls):
            w = _route_kernel(call["backend"])
            print(f"phase {label}: spgemm_csr call {i} backend="
                  f"{call['backend']} wall_s={call['wall']!r} hand-kernel "
                  f"launches (kernel, plain)={call['delta'] or 'none'}")
            check(w is None or call["delta"].get(w.__name__, (0, 0))[0] >= 1,
                  f"{label} call {i} took {call['backend']} but its kernel "
                  f"did not launch")


def _example_run(label: str, fn):
    """Runs `fn` (an example's entry point) once under torch.profiler
    (device activity only), its printed lines re-printed with the card's
    name; prints the wall time and its split: the device time of every
    kernel, copy and memset, and the rest, the host's. Returns fn()."""
    import contextlib
    import io

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof, \
                contextlib.redirect_stdout(buf):
            out = fn()
            torch.cuda.synchronize()
    finally:
        for line in buf.getvalue().splitlines():
            print(f"{CARD} | phase {label}: {line}")
    wall = time.perf_counter() - t0
    dev = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev[e.key] = e.self_device_time_total / 1e3
    dev_ms = sum(dev.values())
    top = ", ".join(f"{k[:48]} {v!r} ms" for k, v in
                    sorted(dev.items(), key=lambda kv: -kv[1])[:5])
    print(f"{CARD} | phase {label}-time: wall_s={wall!r} device_ms="
          f"{dev_ms!r} (torch.profiler: kernels, copies, memsets) host_ms="
          f"{wall * 1e3 - dev_ms!r}; device busy {dev_ms / (wall * 1e3):.1%};"
          f" top device work: {top or 'none'}")
    return out


def run_digit_phase(a0) -> None:
    """Phase 22: spgemm_esc(mode="digit") on random65536 three ways
    (integer values: equal to scipy; Gaussian f32: rtol 1e-5; f64: rtol
    1e-10), no hand kernel; then its timings."""
    import torch

    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.ops.esc import spgemm_esc

    name = f"random{a0.m}"
    _zero_counters(*_all_wrappers())
    t0 = time.perf_counter()
    c, tms, plan = spgemm_esc(a0, a0, mode="digit", device=DEV)
    wall = time.perf_counter() - t0
    slots = sum(cls["slot"].size for cls in plan.classes)
    print(f"{CARD} | phase digit: {name} nnz={a0.nnz} F={plan.num_products} "
          f"nnzC={plan.nnz_c} classes (W, G)="
          f"{[(cls['w'], cls['slot'].shape[0]) for cls in plan.classes]} "
          f"slots={slots} integer wall_s={wall!r} timings_ms={tms}")
    t0 = time.perf_counter()
    ref = golden.spgemm_scipy(a0, a0)
    print(f"phase digit: scipy oracle {time.perf_counter() - t0!r} s")
    _check_exact("digit integer", c, ref)
    del c, ref
    ag = a0.with_data(np.random.default_rng(23).standard_normal(a0.nnz))
    t0 = time.perf_counter()
    plan.refresh_values(ag.data, ag.data)
    ref = golden.spgemm_scipy(ag, ag)
    print(f"phase digit: refresh_values and scipy oracle "
          f"{time.perf_counter() - t0!r} s")
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    c, tms, _ = spgemm_esc(ag, ag, plan=plan, device=DEV)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(f"{CARD} | phase digit: Gaussian f32 wall_s={wall!r} timings_ms="
          f"{tms} peak device memory {peak!r} bytes ({held!r} held before)")
    _check_close("digit f32 Gaussian", c, ref, rtol=GAUSS_RTOL,
                 atol_rel=1e-6)
    t0 = time.perf_counter()
    c, tms, _ = spgemm_esc(ag, ag, plan=plan, dtype=torch.float64,
                           device=DEV)
    wall = time.perf_counter() - t0
    print(f"{CARD} | phase digit: f64 wall_s={wall!r} timings_ms={tms}")
    _check_close("digit f64", c, ref, rtol=F64_RTOL, atol_rel=F64_ATOL)
    del c, ref
    _check_no_kernel("digit")
    digit_timings(plan, ag, peak)


def digit_timings(plan, ag, peak: int) -> None:
    """Phase 22's timing lines: the numeric phase by CUDA events, its
    device split by aten op, the bound (the operand streams and C moved
    once; the one-hot contraction's 2*G*64*W*32 FP32 operations), the
    unchunked temporaries against the peak, torch.sparse.mm on A."""
    import torch

    from spgemm_tpu_torch.ops import esc as pesc

    t0 = time.perf_counter()
    ms = pesc.time_esc(plan, warmup=1, iters=5)
    t1 = time.perf_counter()
    ops = plan.to_device(DEV)
    split = op_split(lambda: pesc.esc_numeric(plan, ops), iters=2)
    print(f"phase digit-time: time_esc call {t1 - t0!r} s, op_split "
          f"{time.perf_counter() - t1!r} s")
    slots = sum(cls["slot"].size for cls in plan.classes)
    moved = _nbytes(t for d in ops for t in d.values()) + plan.nnz_c * 4
    flops = 2.0 * slots * pesc.HI_W * pesc.LO_W
    b_ms, b_by = bound_bytes("digit mode numeric (f32)", moved,
                             [(flops, "f32")])
    del ops
    a_t = _torch_csr(ag, torch.float32)
    lib = library_ms("torch.sparse.mm(A_csr, A_csr) f32 at random65536 "
                     "(digit)", lambda: torch.sparse.mm(a_t, a_t), iters=3)
    del a_t
    total = sum(split.values())
    shares = ", ".join(f"{k} {v!r} ms ({v / total:.1%})"
                       for k, v in split.items()) if total else "none"
    unchunked = slots * ((pesc.HI_W + pesc.LO_W) * 5 + 8)
    print(f"{CARD} | phase digit-time: numeric_ms={ms!r} (CUDA events, "
          f"median of 5, every width class) bound_ms={b_ms!r} (by {b_by}; "
          f"{flops!r} FP32 operations, {moved} bytes) share "
          f"{b_ms / ms:.1%}; torch.sparse.mm library_ms={lib!r}")
    print(f"{CARD} | phase digit-time: device split per call (torch."
          f"profiler, self device time by op): {shares}; sum {total!r} ms")
    print(f"{CARD} | phase digit-time: peak device memory {peak!r} bytes; "
          f"the unchunked temporaries would take {unchunked!r} bytes, the "
          f"chunk budget is {pesc.DIGIT_BYTES!r}")


def run_triangle_phase(n: int = TRI_N, deg: int = TRI_DEG) -> None:
    """Phase 23: triangle_counting on random_graph(n, deg); the count must
    equal scipy's sum(A .* A^2) / 6."""
    from spgemm_tpu_torch.examples import triangle_counting as tc

    adj = tc.random_graph(n, deg)
    print(f"{CARD} | phase triangle: random_graph({n}, {deg}) "
          f"{adj.nnz} directed edges")
    _zero_counters(*_all_wrappers())
    with _CsrSpy(tc) as spy:
        t = _example_run("triangle",
                         lambda: tc.count_triangles(adj, device=DEV))
    spy.check("triangle")
    _launched("triangle")
    sa = _sp(adj)
    sa.data[:] = 1.0
    ref = int(round(sa.multiply(sa @ sa).sum() / 6))
    print(f"phase check: triangle count={t} scipy={ref}")
    check(t == ref, f"triangle count {t} differs from scipy's {ref}")


def run_amg_phase(g: int = AMG_G, levels: int = AMG_LEVELS) -> None:
    """Phase 24: amg_galerkin.coarsen; its own check (pattern equal, rtol
    1e-5 against scipy) must pass at every level."""
    from spgemm_tpu_torch.examples import amg_galerkin as am

    _zero_counters(*_all_wrappers())
    with _CsrSpy(am) as spy:
        try:
            coarse = _example_run("amg",
                                  lambda: am.coarsen(g, levels, device=DEV))
        except SystemExit as e:
            raise SmokeFailure(f"amg_galerkin's check failed ({e})") from e
    spy.check("amg")
    _launched("amg")
    print(f"phase check: amg {levels} levels from {g * g} unknowns verified "
          f"by the example; coarsest {coarse[-1].shape} nnz "
          f"{coarse[-1].nnz}")


def run_mcl_phase(n: int = MCL_N) -> None:
    """Phase 25: markov_clustering.mcl; each iteration's expansion against
    scipy on the same M (pattern equal after dropping explicit zeros, rtol
    1e-5, atol 1e-6*max|C|)."""
    from spgemm_tpu_torch.examples import markov_clustering as mc
    from spgemm_tpu_torch.ops import golden

    adj = mc.clustered_graph(n)
    _zero_counters(*_all_wrappers())
    with _CsrSpy(mc, keep=True) as spy:
        labels = _example_run("mcl", lambda: mc.mcl(adj, device=DEV))
    spy.check("mcl")
    _launched("mcl")
    for i, call in enumerate(spy.calls):
        _check_close(f"mcl iteration {i} expansion", call["c"],
                     golden.spgemm_scipy(call["a"], call["a"]),
                     rtol=GAUSS_RTOL, atol_rel=1e-6)
    n_found = np.unique(labels[labels >= 0]).size
    print(f"phase mcl: {n} nodes, {adj.nnz} edges: clusters found "
          f"{n_found}; routes {[c['backend'] for c in spy.calls]}")


def run_pagerank_phase(n: int = PR_N, deg: int = PR_DEG) -> None:
    """Phase 26: pagerank's iteration, within L1 1e-5 of the same
    iteration count in f64 with scipy, summing to 1 within 1e-3; then the
    two-hop pattern through spgemm_esc, equal to scipy's A^2 pattern."""
    from spgemm_tpu_torch.examples import pagerank as pr
    from spgemm_tpu_torch.ops import scan_kernels
    from spgemm_tpu_torch.utils.generators import rmat

    g = rmat(np.random.default_rng(7), n, deg, values="ones")
    print(f"{CARD} | phase pagerank: R-MAT n={n} edges={g.nnz}")
    _zero_counters(*_all_wrappers())
    x, iters = _example_run("pagerank", lambda: pr.pagerank(g, device=DEV))
    p, dangling = pr.transition(g)
    sp_p, d = _sp(p), pr.DAMPING
    xr = np.full(n, 1.0 / n)
    for _ in range(iters):
        xr = d * (sp_p @ xr) + (d * xr[dangling].sum() + 1 - d) / n
    l1 = float(np.abs(x[:, 0] - xr).sum())
    total = float(x.sum())
    print(f"phase check: pagerank {iters} iterations L1 to the f64 scipy "
          f"iteration {l1!r} (limit 1e-5) sum {total!r}")
    check(l1 <= 1e-5 and abs(total - 1.0) < 1e-3,
          f"pagerank differs from scipy's: L1 {l1}, sum {total}")
    c2, tms, plan = _example_run("pagerank-two-hop",
                                 lambda: pr.spgemm_esc(g, g, device=DEV))
    _launched("pagerank", required=(scan_kernels.esc_scan,))
    s2 = (_sp(g) @ _sp(g)).tocsr()
    s2.sort_indices()
    same = (np.array_equal(c2.indptr, s2.indptr)
            and np.array_equal(c2.indices, s2.indices))
    print(f"phase check: pagerank two-hop pairs {c2.nnz} (F "
          f"{plan.num_products}) scipy {s2.nnz} pattern_equal={same} "
          f"timings_ms={tms}")
    check(same, "the two-hop pattern differs from scipy's A^2")


def run_power_phase(n: int = PM_N, band: int = PM_BAND,
                    iters: int = PM_ITERS) -> None:
    """Phase 27: power_method with x resident: the narrow SpMM kernel
    launches once per iteration, lambda within 1e-5 relative of the f64
    Rayleigh quotient of the final x."""
    from spgemm_tpu_torch.examples import power_method as pm
    from spgemm_tpu_torch.ops import spmm_kernels
    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    a = pm.banded_spd(n, band)
    print(f"{CARD} | phase power: banded_spd({n}, {band}) nnz={a.nnz}")
    w = spmm_kernels.spmm_strip
    _zero_counters(*_all_wrappers())
    lam, x, ps = _example_run(
        "power", lambda: pm.power_iteration(a, iters, device=DEV))
    _launched("power", required=(w,))
    print(f"phase check: power narrow-form launches {w.narrow_launches} of "
          f"{w.kernel_launches} (expected {iters})")
    check(w.kernel_launches == w.narrow_launches == iters,
          f"power_method launched {w.kernel_launches} SpMM kernels, "
          f"{w.narrow_launches} narrow, not {iters}")
    xd = x.double().cpu().numpy()
    ax = _sp(a) @ xd
    rq = float(xd @ ax / (xd @ xd))
    resid = float(np.linalg.norm(ax - lam * xd) / abs(lam))
    print(f"phase check: power lambda={lam!r} f64 Rayleigh quotient {rq!r} "
          f"rel diff {abs(lam - rq) / abs(rq)!r} (limit 1e-5) "
          f"|Ax - lambda x|/|lambda| {resid!r}")
    check(abs(lam - rq) <= 1e-5 * abs(rq),
          f"power_method's lambda {lam} differs from the Rayleigh quotient")
    step_ms = cuda_event_ms(lambda: ps.step(x), warmup=3, iters=20)
    print(f"{CARD} | phase power-time: per-iteration ms {step_ms!r} (CUDA "
          f"events, median of 20: pack x, one narrow SpMM launch, norm, "
          f"dot)")


def run_serving_phase(n: int = SERVE_N, ticks: int = SERVE_TICKS) -> None:
    """Phase 28: serving_loop.serve: every tick of the three executors
    must print OK; the strip and the premul scan kernel must launch."""
    from spgemm_tpu_torch.examples import serving_loop as sl
    from spgemm_tpu_torch.ops import kernels, scan_kernels

    _zero_counters(*_all_wrappers())
    ok = _example_run("serving", lambda: sl.serve(n, ticks, device=DEV))
    _launched("serving", required=(kernels.strip_numeric,
                                   scan_kernels.esc_scan))
    print(f"phase check: serving {n} x {ticks} ticks all OK: {ok}")
    check(ok, "a serving_loop tick printed MISMATCH")
    serving_f32_yardstick(SERVE_FULL_N, ticks)


def serving_f32_yardstick(n: int, ticks: int) -> None:
    """The serving loop's strip check (rtol 1e-4, atol 1e-6) applied to
    scipy's own f32 product on the example's tick values at n: the worst
    |C - C64| / (atol + rtol |C64|) per tick; above 1 is a MISMATCH."""
    from spgemm_tpu_torch.examples import serving_loop as sl

    rng = np.random.default_rng(42)   # serve()'s tick values, in order
    a = sl.banded(n, 16)
    sb = _sp(a)
    worst = []
    for _ in range(ticks):
        sa = _sp(a.with_data(rng.standard_normal(a.nnz)))
        ref = (sa @ sb).tocsr()
        c32 = (sa.astype(np.float32) @ sb.astype(np.float32)).tocsr()
        ref.sort_indices()
        c32.sort_indices()
        check(np.array_equal(c32.indices, ref.indices), "f32 pattern")
        worst.append(float((np.abs(c32.data - ref.data)
                            / (1e-6 + 1e-4 * np.abs(ref.data))).max()))
    print(f"phase serving: the strip ticks' check on scipy's f32 product "
          f"at n={n}: worst error / tolerance per tick {worst}")


def run_entry_phase() -> None:
    """Phase 29: entry() on the card equals the CPU's (integer values)."""
    import torch

    from spgemm_tpu_torch.entry import entry

    _zero_counters(*_all_wrappers())
    fn, args = entry(device=DEV)
    got = fn(*args)
    torch.cuda.synchronize()
    fn_c, args_c = entry(device="cpu")
    same = all(torch.equal(x.cpu(), y) for x, y in zip(got, fn_c(*args_c)))
    print(f"phase entry: {len(args)} tensors on {args[0].device}, c_val "
          f"{tuple(got[0].shape)} equal to the CPU's: {same}")
    check(same, "entry() on the card differs from the CPU")
    _check_no_kernel("entry")


def run_example_phases(rnd) -> None:
    """Phases 22-29, with their total wall time."""
    t0 = time.perf_counter()
    run_digit_phase(rnd)
    run_triangle_phase()
    run_amg_phase()
    run_mcl_phase()
    run_pagerank_phase()
    run_power_phase()
    run_serving_phase()
    run_entry_phase()
    print(f"{CARD} | phase examples: phases 22-29 took "
          f"{time.perf_counter() - t0!r} s")


# --- the multi-device layer (spgemm_tpu_torch/parallel/dist.py) -------------
# gloo's collectives on CUDA tensors (the probe of PERF.md, torch 2.11):
# all_gather_into_tensor and all_gather run, batch_isend_irecv does not
# (writev fails) and breaks the group, so two ranks on one card run every
# formulation but the ring, which dist-1 (NCCL) and the CPU tests cover.
GLOO_CUDA_FORMS = ("pairs", "gustavson", "strip", "esc", "ozaki")
DIST_TEMP_LIMIT = 16 << 30      # cut a dist-1 matrix whose temporaries pass it


def _dist_profiled(fn):
    """fn() under torch.profiler: (result, wall s, collective ms: the
    device time of the work the c10d collectives launched, NCCL kernels
    and copies alike, with the ops counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cpu_ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CPU]
    # the dispatcher's c10d ops, else the backend's own ranges (not both:
    # one holds the other)
    ops = ({e.key: e.device_time_total / 1e3 for e in cpu_ops
            if e.key.startswith("c10d::")}
           or {e.key: e.device_time_total / 1e3 for e in cpu_ops
               if e.key.startswith("nccl:")})
    print(f"phase dist: collective ops (device ms) {ops or 'none'}")
    return out, wall, sum(ops.values())


def _dist_line(label: str, timer, kernel_ms: float, coll_ms: float,
               wall: float) -> None:
    ms = timer.ms
    print(f"{CARD} | phase {label}: plan_ms={ms.get('plan', 0.0)!r} "
          f"upload_ms={ms.get('upload', 0.0)!r} kernel_ms={kernel_ms!r} "
          f"(CUDA events, median; host numeric step "
          f"{ms.get('numeric', 0.0)!r} ms) collective_ms={coll_ms!r} "
          f"(torch.profiler, under the c10d ops; host collective step "
          f"{ms.get('collective', 0.0)!r} ms) assemble_ms="
          f"{ms.get('assemble', 0.0)!r} wall_s={wall!r}")


def _dist_run(label: str, fn, kernel_ms_fn, required=(), torch_ops=False):
    """One dist-1 formulation with the counters zeroed: fn(timer) under
    the profiler, then its kernel time; checks the launches (`required`
    hand kernels launched and no plain version ran, or with `torch_ops`
    no hand kernel at all). Returns C."""
    from spgemm_tpu_torch.utils.timing import StepTimer

    _zero_counters(*_all_wrappers())
    timer = StepTimer()
    c, wall, coll = _dist_profiled(lambda: fn(timer))
    if torch_ops:
        _check_no_kernel(label)
    else:
        _launched(label, required)
    _dist_line(label, timer, kernel_ms_fn(), coll, wall)
    return c


def run_dist_one_rank(rmat) -> None:
    """Phase 30 (dist-1): a one-rank NCCL process group on the card, every
    formulation at full size: (a) strip on the cant-like A^2 at 64x128 /
    128x128 (C equal to scipy and to spgemm_csr's C on integer values;
    Gaussian values at rtol 1e-5), (b) ESC on the suite's rmat65536 A^2
    (C exact, no skew fallback), (c) gustavson, ring and pairs on the
    cant-like A^2 at 16x16 (exact), after counting each one's gathered
    bytes and temporaries, (d) Ozaki f64 on the cant-like at 16x128 /
    128x128 (integer values bit-equal to scipy, Gaussian within
    1e-12*max|C|). Leaves the group initialised for phases 31-32."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden, kernels, numeric, scan_kernels
    from spgemm_tpu_torch.ops.esc import build_esc_scan_plan
    from spgemm_tpu_torch.ops.gustavson import gustavson_core
    from spgemm_tpu_torch.ops.ozaki import ozaki_core
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr
    from spgemm_tpu_torch.parallel import dist as pdist
    from spgemm_tpu_torch.utils.generators import cantlike
    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    t_phase = time.perf_counter()
    backend = "nccl" if DEV == "cuda" else "gloo"
    pdist.init_multihost(f"127.0.0.1:{pdist._free_port()}", num_processes=1,
                         process_id=0, backend=backend)
    mesh = pdist.make_mesh(1, device=DEV)
    print(f"phase dist-1: {backend} group of {mesh.size} rank on "
          f"{mesh.device}")
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEV)

    # (a) strip at the main path's tiles
    a = cantlike(ROWS, BAND)
    ref = golden.spgemm_scipy(a, a)
    at, bt = csr_to_tiles(a, TM, TN), csr_to_tiles(a, TN, TN)
    arrays, splan = pdist.place_strip_partition(at, bt, mesh)
    strip_ms = lambda: cuda_event_ms(
        lambda: kernels.strip_numeric(*arrays[:7], **splan.kernel_kwargs),
        warmup=3, iters=20)
    c = _dist_run("dist-1 strip", lambda t: pdist.spgemm_sharded_strip(
        at, bt, mesh, timer=t), strip_ms, required=(kernels.strip_numeric,))
    _check_exact("dist-1 strip", c.to_csr(), ref)
    c1, _ = spgemm_csr(a, tm=TM, tn=TN, device=DEV)
    same = golden.drop_explicit_zeros(c.to_csr()) == \
        golden.drop_explicit_zeros(c1)
    print(f"phase check: dist-1 strip equal to spgemm_csr's C: {same}")
    check(same, "dist-1 strip differs from spgemm_csr")
    del arrays, c1
    ag = a.with_data(np.random.default_rng(0).standard_normal(a.nnz))
    ref_g = golden.spgemm_scipy(ag, ag)
    atg, btg = csr_to_tiles(ag, TM, TN), csr_to_tiles(ag, TN, TN)
    arrays, splan = pdist.place_strip_partition(atg, btg, mesh)
    c = _dist_run("dist-1 strip-gaussian",
                  lambda t: pdist.spgemm_sharded_strip(atg, btg, mesh,
                                                       timer=t),
                  strip_ms, required=(kernels.strip_numeric,))
    _check_close("dist-1 strip-gaussian", c.to_csr(), ref_g,
                 rtol=GAUSS_RTOL, atol_rel=1e-6)
    del atg, btg, c, arrays
    torch.cuda.empty_cache()

    # (b) ESC at rmat65536; the host plan is kept for the kernel's timing
    before = pdist.spgemm_sharded_esc.single_device_fallbacks
    held = {}

    def esc(t):
        with t.step("plan"):
            held["plan"] = build_esc_scan_plan(rmat, rmat,
                                               keep_sources=False)
        return pdist.spgemm_sharded_esc(rmat, rmat, mesh, plan=held["plan"],
                                        timer=t)

    def esc_ms():
        eplan = held["plan"]
        dev = eplan.to_device(DEV)
        return cuda_event_ms(lambda: scan_kernels.esc_scan(
            dev["qv"], dev["meta"], passes=eplan.passes,
            group_rows=eplan.group_rows), warmup=2, iters=10)

    c = _dist_run("dist-1 esc", esc, esc_ms,
                  required=(scan_kernels.esc_scan,))
    check(pdist.spgemm_sharded_esc.single_device_fallbacks == before,
          "dist-1 esc took the single-device skew fallback")
    _check_exact("dist-1 esc", c, golden.spgemm_scipy(rmat, rmat))
    del held, c
    torch.cuda.empty_cache()

    # (c) the torch-op formulations at TileSpGEMM's 16x16
    a16 = csr_to_tiles(a, SLAB_T, SLAB_T)
    gp = pdist.plan_gustavson_partition(a16, a16, 1)
    rp = pdist.plan_row_partition(a16, a16, 1)
    slab_tmp = 3 * gp.gk * gp.max_a * gp.max_b * SLAB_T * SLAB_T * 4
    pair_tmp = 3 * 2 * min(32768, rp.pa.shape[1]) * SLAB_T * SLAB_T * 4
    for name, gathered, tmp in (
            ("gustavson", gp.b3_val.nbytes + gp.b3_occ.nbytes, slab_tmp),
            ("ring", gp.b3_val.nbytes + gp.b3_occ.nbytes, slab_tmp),
            ("pairs", rp.b_val.nbytes + rp.b_occ.nbytes, pair_tmp)):
        print(f"phase dist-1 {name}: gathered bytes {gathered} "
              f"(B shards), temporaries about {tmp} bytes (limit "
              f"{DIST_TEMP_LIMIT}): no cut")
        check(tmp <= DIST_TEMP_LIMIT, f"dist-1 {name} temporaries pass "
                                      f"16 GiB: cut the matrix")
    g_ops = [up(x[0]) for x in (gp.a3_val, gp.a3_occ, gp.b3_val, gp.b3_occ,
                                gp.seg)]
    slab_ms = lambda: cuda_event_ms(lambda: gustavson_core(
        *g_ops, gk=gp.gk, max_a=gp.max_a, max_b=gp.max_b, tm=gp.tm,
        tn=gp.tn, nt_c=gp.s_max), warmup=2, iters=10)
    p_ops = [up(x[0]) for x in (rp.a_val, rp.a_occ, rp.b_val, rp.b_occ,
                                rp.pa, rp.pb, rp.seg)]
    pair_ms = lambda: cuda_event_ms(lambda: numeric.pair_accumulate(
        *p_ops, num_segments=rp.s_max), warmup=2, iters=10)
    for name, fn, kms in (("gustavson", pdist.spgemm_sharded, slab_ms),
                          ("ring", pdist.spgemm_sharded_ring, slab_ms),
                          ("pairs", pdist.spgemm_sharded_pairs, pair_ms)):
        c = _dist_run(f"dist-1 {name}",
                      lambda t, fn=fn: fn(a16, a16, mesh, timer=t), kms,
                      torch_ops=True)
        _check_exact(f"dist-1 {name}", c.to_csr(), ref)
    del g_ops, p_ops, gp, rp, a16, c
    torch.cuda.empty_cache()

    # (d) exact f64 through the Ozaki slab engine at 16x128 / 128x128
    for label, m, r in (("ozaki-integer", a, ref),
                        ("ozaki-gaussian", ag, ref_g)):
        ao, bo = csr_to_tiles(m, 16, TN), csr_to_tiles(m, TN, TN)
        op = pdist.plan_ozaki_partition(ao, bo, 1)
        o_ops = [up(x[0]) for x in (op.a_sl, op.b_sl, op.a_occ, op.b_occ,
                                    op.seg)]
        oz_ms = lambda: cuda_event_ms(lambda: ozaki_core(
            *o_ops, gk=op.gk, max_a=op.max_a, max_b=op.max_b, tm=op.tm,
            tn=op.tn, nt_c=op.s_max, sa=op.sa, sb=op.sb), warmup=1,
            iters=5)
        print(f"phase dist-1 {label}: S={op.sa}x{op.sb} gk={op.gk} "
              f"max_a={op.max_a} max_b={op.max_b} C tiles={op.s_max}")
        c = _dist_run(f"dist-1 {label}", lambda t: pdist.spgemm_sharded_ozaki(
            ao, bo, mesh, timer=t), oz_ms, torch_ops=True)
        if m is a:
            _check_exact(f"dist-1 {label}", c.to_csr(), r)
        else:
            _check_close(f"dist-1 {label}", c.to_csr(), r, rtol=0.0,
                         atol_rel=OZ_RTOL)
        del o_ops, op, c
        torch.cuda.empty_cache()
    print(f"{CARD} | phase dist-1: took {time.perf_counter() - t_phase!r} s")


def _dist_problem(n_ranks: int):
    """dryrun_multichip's problem at n_ranks (every rank owns several
    strip blocks at block_rows 2): its CSR and golden C."""
    from spgemm_tpu_torch.entry import _example_problem
    from spgemm_tpu_torch.models.tile import tiles_to_csr
    from spgemm_tpu_torch.ops import golden

    m = max(96, n_ranks * 2 * 2 * 16 * 2)
    a = tiles_to_csr(_example_problem(m=m, density=600 / (m * m), seed=1))
    return a, golden.spgemm_dense_row(a, a)


def _dist_forms(mesh, a) -> dict:
    """GLOO_CUDA_FORMS on `mesh` for C = A^2 (strip and Ozaki at 16x128 /
    128x128, strip at block_rows 2; the others at 16x16): name -> C as
    (indptr, indices, data), explicit zeros dropped."""
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden
    from spgemm_tpu_torch.parallel import dist as pdist

    t16 = csr_to_tiles(a, 16, 16)
    tw, bw = csr_to_tiles(a, 16, TN), csr_to_tiles(a, TN, TN)
    runs = {"pairs": lambda: pdist.spgemm_sharded_pairs(t16, t16, mesh),
            "gustavson": lambda: pdist.spgemm_sharded(t16, t16, mesh),
            "strip": lambda: pdist.spgemm_sharded_strip(tw, bw, mesh,
                                                        block_rows=2),
            "esc": lambda: pdist.spgemm_sharded_esc(a, a, mesh),
            "ozaki": lambda: pdist.spgemm_sharded_ozaki(tw, bw, mesh)}
    out = {}
    for name in GLOO_CUDA_FORMS:
        c = runs[name]()
        c = golden.drop_explicit_zeros(c if name == "esc" else c.to_csr())
        out[name] = (c.indptr, c.indices, c.data)
    return out


def _dist2_rank(device: str):
    """One rank of phase 31: two ranks on the one card over gloo."""
    from spgemm_tpu_torch.parallel import dist as pdist

    mesh = pdist.make_mesh(2, device=device)
    a, _ = _dist_problem(2)
    _zero_counters(*_all_wrappers())
    t0 = time.perf_counter()
    out = _dist_forms(mesh, a)
    return out, _counts(), str(mesh.device), time.perf_counter() - t0


def run_dist_two_ranks() -> None:
    """Phase 31 (dist-2): two processes, both on the card, over gloo,
    at a size where each rank owns at least two strip blocks: every
    formulation gloo carries on CUDA tensors (GLOO_CUDA_FORMS); each
    rank's C equals the other's, the one-rank C of this process and the
    golden C; each rank launched the strip and scan kernels and ran no
    plain version."""
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import kernels, scan_kernels
    from spgemm_tpu_torch.parallel import dist as pdist

    t0 = time.perf_counter()
    a, ref = _dist_problem(2)
    sp = pdist.plan_strip_partition(csr_to_tiles(a, 16, TN),
                                    csr_to_tiles(a, TN, TN), 2, block_rows=2)
    blocks = [-(-int(sp.row_lo[d + 1] - sp.row_lo[d]) // 2) for d in (0, 1)]
    print(f"phase dist-2: {a.m}^2, nnz={a.nnz}, strip blocks per rank "
          f"{blocks}; formulations {GLOO_CUDA_FORMS} (the ring's "
          f"batch_isend_irecv does not run over gloo on CUDA tensors)")
    check(min(blocks) >= 2, f"dist-2: a rank owns fewer than two strip "
                            f"blocks: {blocks}")
    one = _dist_forms(pdist.make_mesh(1, device=DEV), a)
    ranks = pdist.spawn_ranks(_dist2_rank, 2, backend="gloo", args=(DEV,),
                              timeout=600)
    for r, (out, counts, dev, secs) in enumerate(ranks):
        print(f"{CARD} | phase dist-2: rank {r} on {dev}: {secs!r} s; "
              f"hand-kernel launches (kernel, plain) {counts}")
        check(not any(v[1] for v in counts.values()),
              f"dist-2 rank {r} ran a plain version")
        for w in (kernels.strip_numeric, scan_kernels.esc_scan):
            check(counts[w.__name__][0] >= 1,
                  f"dist-2 rank {r} did not launch {w.__name__}")
        for name in GLOO_CUDA_FORMS:
            got = out[name]
            same = all(np.array_equal(x, y) for x, y in zip(got, one[name]))
            gold = (np.array_equal(got[0], ref.indptr)
                    and np.array_equal(got[1], ref.indices)
                    and np.array_equal(got[2], ref.data))
            print(f"phase check: dist-2 rank {r} {name}: nnzC="
                  f"{got[2].size} equal to the one-rank C {same}, to "
                  f"golden {gold}")
            check(same and gold, f"dist-2 rank {r} {name} differs")
    print(f"{CARD} | phase dist-2: took {time.perf_counter() - t0!r} s")


def run_dryrun_phase() -> None:
    """Phase 32: dryrun_multichip(1) in this process's one-rank group;
    then the group is destroyed."""
    import torch.distributed as dist

    from spgemm_tpu_torch.entry import dryrun_multichip

    t0 = time.perf_counter()
    _zero_counters(*_all_wrappers())
    dryrun_multichip(1, device=None if DEV == "cuda" else DEV)
    _launched("dryrun")
    dist.destroy_process_group()
    print(f"{CARD} | phase dryrun: took {time.perf_counter() - t0!r} s")


# --- phases 33-35: the tools through their entry points ----------------
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "e2e_ms", "sol_ms",
              "sol_pct", "f64_gflops", "f64_vs_baseline", "f64_int_gflops")
TOOL_TIMEOUT = 600              # seconds, each tool
# Runs one module as `python -m` would (runpy, run_name "__main__") in
# this fresh interpreter, with every launch counter zeroed first, and
# writes the counters to argv[1] however the module ends.
_TOOL_WRAPPER = """
import json, runpy, sys
from chip_smoke import _all_wrappers, _counts, _zero_counters
out, mod = sys.argv[1], sys.argv[2]
sys.argv = [mod] + sys.argv[3:]
_zero_counters(*_all_wrappers())
try:
    runpy.run_module(mod, run_name="__main__", alter_sys=True)
finally:
    with open(out, "w") as f:
        json.dump(_counts(), f)
"""


def run_tool(label: str, module: str, argv=(), required=(), env=None):
    """Phases 33-35 and 39: `module` through its entry point in a fresh
    interpreter; prints its output's last lines and the hand-kernel
    launches of that process; fails if it exits non-zero, runs a plain
    version or leaves a `required` kernel unlaunched. Returns (stdout,
    stderr, {wrapper name: (kernel, plain) launches})."""
    with tempfile.TemporaryDirectory() as d:
        counts_path = os.path.join(d, "counts.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _TOOL_WRAPPER, counts_path, module,
             *argv], capture_output=True, text=True, timeout=TOOL_TIMEOUT,
            env={**os.environ, **(env or {})})
        wall = time.perf_counter() - t0
        for stream, text in (("stderr", proc.stderr), ("stdout", proc.stdout)):
            for line in text.splitlines()[-40:]:
                print(f"phase {label} {stream}: {line}")
        check(os.path.exists(counts_path),
              f"{label}: the tool's process wrote no launch counts")
        with open(counts_path) as f:
            counts = {k: tuple(v) for k, v in json.load(f).items()}
    ran = {k: v for k, v in counts.items() if v != (0, 0)}
    print(f"{CARD} | phase {label}: exit {proc.returncode} in {wall!r} s; "
          f"hand-kernel launches (kernel, plain): {ran or 'none'}")
    check(proc.returncode == 0, f"{label} exited {proc.returncode}")
    plain = {k: v for k, v in ran.items() if v[1]}
    check(not plain, f"{label} ran a plain version: {plain}")
    missing = [w.__name__ for w in required if counts[w.__name__][0] == 0]
    check(not missing, f"{label} did not launch {missing}")
    return proc.stdout, proc.stderr, counts


def run_tool_phases(cant_nnz_c: int, numeric_ms: float) -> None:
    """Phases 33-35: the bench, the verify drive and the suite runner."""
    import re

    from spgemm_tpu_torch.ops import (kernels, ozaki_kernels, scan_kernels,
                                      spmm_kernels)

    t_all = time.perf_counter()
    out, err, _ = run_tool("bench", "spgemm_tpu_torch.bench", required=(
        kernels.strip_numeric, ozaki_kernels.ozaki_strip_numeric,
        scan_kernels.esc_scan_dd))
    line = json.loads(out.strip().splitlines()[-1])
    missing = [k for k in BENCH_KEYS if k not in line]
    check(not missing, f"bench line lacks {missing}")
    nnz_c = int(re.search(r"nnzC=(\d+)", err).group(1))
    bench_ms = float(re.search(r"# numeric_ms=([0-9.]+)", err).group(1))
    print(f"{CARD} | phase bench: value={line['value']!r} "
          f"sol_pct={line['sol_pct']!r} nnzC={nnz_c} (scipy {cant_nnz_c}) "
          f"numeric_ms={bench_ms!r} (phase 5: {numeric_ms!r}, ratio "
          f"{bench_ms / numeric_ms!r})")
    check(line["value"] > 0 and line["sol_pct"] <= 100,
          f"bench value {line['value']} or sol_pct {line['sol_pct']}")
    check(nnz_c == cant_nnz_c, f"bench nnzC {nnz_c} != scipy's {cant_nnz_c}")
    check(abs(bench_ms / numeric_ms - 1) <= 0.10,
          f"bench numeric_ms {bench_ms} is not within 10% of phase 5's "
          f"{numeric_ms}")

    out, _, _ = run_tool("verify", "spgemm_tpu_torch.tools.verify_cuda",
                      required=(kernels.strip_numeric, scan_kernels.esc_scan,
                                scan_kernels.esc_scan_mul,
                                scan_kernels.esc_scan_dd,
                                ozaki_kernels.ozaki_strip_numeric,
                                spmm_kernels.spmm_strip))
    last = out.strip().splitlines()[-1]
    check(last == "FAILS: 0", f"verify_cuda ended with {last!r}")

    with tempfile.TemporaryDirectory() as d:
        run_tool("suite", "spgemm_tpu_torch.tools.run_suite",
                 ["--n", "8192", "--configs", "A2", "--outdir", d],
                 required=(kernels.strip_numeric, scan_kernels.esc_scan,
                           scan_kernels.esc_scan_mul))
        import csv

        with open(os.path.join(d, "suite_summary.csv")) as f:
            rows = list(csv.DictReader(f))
    bad = [(r["matrix"], r["check"]) for r in rows if r["check"] != "PASSED"]
    print(f"phase suite: {len(rows)} rows, backends "
          f"{[r['backend'] for r in rows]}, not passed: {bad or 'none'}")
    check(len(rows) == 5 and not bad, f"run_suite rows not passed: {bad}")
    print(f"{CARD} | phase tools: phases 33-35 took "
          f"{time.perf_counter() - t_all!r} s")


# --- tile shapes beyond the kernels' instantiated heights --------------------
# Each kernel cuts a tm % 8 == 0, tn % 128 == 0 tile into chunks of the
# heights it is instantiated for (ops/kernels.py:chunk_grid,
# spmm_kernels.sub_tiles, ozaki_kernels.ozaki_grid).
CHUNK_TILES = ((24, 128), (128, 128), (8, 256), (40, 384))  # strip, pair
OZ_CHUNK_TILES = ((8, 128), (64, 128), (24, 256))
SPMM_CHUNK_TM = (24, 128)
BIG_TILES = ((128, 128), (40, 256))   # the cant-like A^2 through the strip
PAIR_BIG = (128, 128)
OZ_BIG = (64, 128)                    # bench.py's A tiling, in f64
SPMM_BIG = (128, 128)


def _shape(tm, tn) -> str:
    return f"{tm}x{tn}"


def compare_tile_shapes() -> dict:
    """Phase 36: the strip, pair, Ozaki and SpMM kernels against their
    plain versions at tile shapes past the instantiated ones, on random
    banded plans. Returns {kernel name: [tile shapes held]}."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import kernels
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops import pair_kernels as pk
    from spgemm_tpu_torch.ops import spmm as pspmm
    from spgemm_tpu_torch.ops import spmm_kernels as smk
    from spgemm_tpu_torch.ops.gustavson import build_strip_args
    from spgemm_tpu_torch.ops.ozaki import build_ozaki_strip
    from spgemm_tpu_torch.ops.symbolic import build_pair_schedule
    from spgemm_tpu_torch.utils.generators import banded

    held = {"strip_numeric": [], "pair_accumulate": [], "ozaki_strip": [],
            "spmm_strip": []}
    rng = np.random.default_rng(29)
    base = banded(rng, 3000, 64)
    gauss = base.with_data(rng.standard_normal(base.nnz))
    for tm, tn in CHUNK_TILES:
        parts, cols = kernels.chunk_grid(tm, tn)
        rows = "+".join(f"{n}x{h}" for h, _, n in parts)
        for values, a in (("integer", base), ("gaussian", gauss)):
            at, bt = csr_to_tiles(a, tm, tn), csr_to_tiles(a, tn, tn)
            for window in (None, False):
                args = build_strip_args(at, bt, window=window)
                ops = args.to_device("cuda")
                kw = args.kernel_kwargs()
                cv, cc = kernels.strip_numeric(*ops, **kw)
                pv, pc = kernels.strip_numeric_plain(*ops, **kw)
                torch.cuda.synchronize()
                ok_, err, _ = ((torch.equal(cv, pv), (cv - pv).abs().max()
                                .item(), 0.0) if values == "integer"
                               else _close(cv, pv))
                print(f"phase tile-compare: strip {_shape(tm, tn)} "
                      f"(row chunks {rows}, {cols} column chunks) "
                      f"window={window} "
                      f"{values} slots={cv.shape[0]} max_abs_err={err!r} "
                      f"values_ok={ok_} counts_equal={torch.equal(cc, pc)}")
                check(ok_ and torch.equal(cc, pc),
                      f"strip kernel differs from its plain version at "
                      f"{_shape(tm, tn)} ({window}, {values}): {err}")
                del ops, cv, cc, pv, pc
            sched = build_pair_schedule(at, bt)
            ops = _pair_operands(at, bt, sched, "cuda", torch.bfloat16)
            gv, gc = pk.pair_accumulate_cuda(*ops, num_segments=sched.nt_c)
            pv, pc = pk.pair_accumulate_plain(*ops, num_segments=sched.nt_c)
            torch.cuda.synchronize()
            ok_, err, _ = ((torch.equal(gv, pv), (gv - pv).abs().max()
                            .item(), 0.0) if values == "integer"
                           else _close(gv, pv))
            print(f"phase tile-compare: pair {_shape(tm, tn)} {values} "
                  f"C tiles={sched.nt_c} pairs={sched.num_pairs} "
                  f"max_abs_err={err!r} values_ok={ok_} "
                  f"counts_equal={torch.equal(gc, pc)}")
            check(ok_ and torch.equal(gc, pc),
                  f"pair kernel differs from its plain version at "
                  f"{_shape(tm, tn)} ({values}): {err}")
            del ops, gv, gc, pv, pc
        held["strip_numeric"].append(_shape(tm, tn))
        held["pair_accumulate"].append(_shape(tm, tn))

    for tm, tn in OZ_CHUNK_TILES:
        for label, x in (("integer", base), ("gaussian", gauss)):
            plan = build_ozaki_strip(csr_to_tiles(x, tm, tn),
                                     csr_to_tiles(x, tn, tn))
            ops = plan.to_device("cuda")
            kw = plan.kernel_kwargs()
            got = ok.ozaki_strip_numeric(*ops, **kw)
            exp = ok.ozaki_strip_numeric_plain(*ops, **kw)
            torch.cuda.synchronize()
            equal = [torch.equal(g, e) for g, e in zip(got, exp)]
            print(f"phase tile-compare: ozaki {_shape(tm, tn)} (grid y, z "
                  f"{ok.ozaki_grid(tm, tn)}) {label} S={plan.sa}x{plan.sb} "
                  f"pmax={plan.pmax} slots={got[0].shape[0]} "
                  f"bit_equal(h, m, l, cnt)={equal}")
            check(all(equal), f"the Ozaki kernel differs from its plain "
                              f"version at {_shape(tm, tn)} ({label})")
            del ops, got, exp
        held["ozaki_strip"].append(_shape(tm, tn))

    block_rows = 16
    for tm in SPMM_CHUNK_TM:
        for values, a in (("integer", base), ("gaussian", gauss)):
            x = (rng.integers(-4, 5, (a.n, 256)).astype(np.float64)
                 if values == "integer" else rng.standard_normal((a.n, 256)))
            t = csr_to_tiles(a, tm, TN)
            stats = pspmm._spmm_block_stats(t, block_rows)
            kmin = torch.from_numpy(pspmm._window_kmin(t, stats)).to("cuda")
            for k in (1, 128, 256):
                width = smk.pack_width(k)
                ops, smap = _spmm_ops(t, x[:, :k], width, block_rows)
                for form, km in (("resident", None), ("window", kmin)):
                    got = smk.spmm_strip(*ops, km, gm=t.gm,
                                         block_rows=block_rows, smap=smap)
                    exp = smk.spmm_strip_plain(*ops, km, gm=t.gm,
                                               block_rows=block_rows)
                    torch.cuda.synchronize()
                    ok_, err, _ = ((torch.equal(got, exp), (got - exp).abs()
                                    .max().item(), 0.0)
                                   if values == "integer"
                                   else _close(got, exp))
                    print(f"phase tile-compare: spmm tm {tm} (sub-tiles "
                          f"{smk.sub_tiles(tm)}) {form} {values} k={k} "
                          f"width={width} max_abs_err={err!r} ok={ok_}")
                    check(ok_, f"SpMM kernel differs from its plain version "
                               f"at tm {tm} ({form}, {values}, k {k}): {err}")
                del ops
        held["spmm_strip"].append(_shape(tm, TN))
    return held


def _chunk_time(label, entry, ms, bnd, base_ms, base_tiles) -> None:
    print(f"{CARD} | phase tiles-time: {label} kernel_ms={ms!r} "
          f"bound_ms={bnd[0]!r} ({bnd[1]}) share {bnd[0] / ms:.1%}; the "
          f"{base_tiles} instantiation on the same matrix {base_ms!r} ms")
    entry.update(ms=ms, bound_ms=bnd[0], bound_by=bnd[1])


def run_tile_shapes_phase(a, ref, ag, ref_g, banded, base_ms) -> dict:
    """Phase 37: the main path at tile shapes past the instantiated ones,
    at full size, counters zeroed before each route: the cant-like A^2
    through the strip kernel at 128x128 and 40x256 (integer exact,
    Gaussian within rtol 1e-5), the pair kernel at 128x128, the f64 Ozaki
    kernel at 64x128 (Gaussian within 1e-12*max|C|, the integer model
    exact) and SpMM/SpMV at 128x128 on banded65536, each against scipy
    with no plain version run; then each kernel's time (CUDA events)
    beside its bound and the instantiated shape's time from the earlier
    phases (`base_ms`: {kernel: ms}). Returns {kernel: {shape: entry}}."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import golden, kernels
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops import pair_kernels as pk
    from spgemm_tpu_torch.ops import spmm as pspmm
    from spgemm_tpu_torch.ops import spmm_kernels as smk
    from spgemm_tpu_torch.ops.executor import StripExecutor
    from spgemm_tpu_torch.ops.spgemm import spgemm, spgemm_csr
    from spgemm_tpu_torch.ops.spmm import spmm, spmv
    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    out = {"strip_numeric": {}, "pair_accumulate": {}, "ozaki_strip": {},
           "spmm_strip": {}}
    strip = kernels.strip_numeric
    for tm, tn in BIG_TILES:
        shape = _shape(tm, tn)
        entry = {}
        for values, x, oracle in (("integer", a, ref), ("gaussian", ag,
                                                        ref_g)):
            torch.cuda.empty_cache()
            _zero_counters(*_all_wrappers())
            t0 = time.perf_counter()
            c, res = spgemm_csr(x, tm=tm, tn=tn, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            print(f"phase tiles: strip cant-like {shape} {values} backend="
                  f"{res.stats['backend']} wall_s={wall!r} "
                  f"timings_ms={res.timings_ms}")
            check(res.stats["backend"] == "strip",
                  f"auto routing picked {res.stats['backend']} at {shape}")
            _launched(f"strip {shape} {values}", required=(strip,))
            ran = [k for k, v in _counts().items() if v[0]]
            check(ran == [strip.__name__], f"other kernels ran: {ran}")
            entry.setdefault("launches", strip.kernel_launches)
            if values == "integer":
                _check_exact(f"strip {shape} integer", c, oracle)
            else:
                _check_close(f"strip {shape} Gaussian", c, oracle,
                             rtol=GAUSS_RTOL, atol_rel=1e-6)
            del c, res
        at, bt = csr_to_tiles(a, tm, tn), csr_to_tiles(a, tn, tn)
        ex = StripExecutor(at, bt, device="cuda")
        sa = ex.args
        cv, cc = ex.run()
        products = float(sa.num_pairs) * sa.tm * sa.tk * sa.tn
        bnd = bound(f"strip_numeric {shape}", ex._dev, (cv, cc),
                    _f32_mma_ops(products) + [(2 * products, "bf16")])
        del cv, cc
        parts, cols = kernels.chunk_grid(tm, tn)
        n_slots = -(-sa.gm // sa.block_rows) * sa.max_cblock
        print(f"phase tiles: strip {shape} plan pairs={sa.num_pairs} "
              f"padded_slots={n_slots} row chunks (height, first row, "
              f"count)={parts} column chunks={cols}: CTAs="
              f"{n_slots * sum(n for _, _, n in parts) * cols}")
        _chunk_time(f"strip {shape}", entry,
                    ex.time_numeric(warmup=3, iters=30), bnd,
                    base_ms["strip_numeric"], _shape(TM, TN))
        out["strip_numeric"][shape] = entry
        del ex
        torch.cuda.empty_cache()

    # the pair kernel through backend="pallas"
    tm, tn = PAIR_BIG
    shape = _shape(tm, tn)
    w = pk.pair_accumulate_cuda
    _zero_counters(*_all_wrappers())
    c, res = spgemm_csr(a, tm=tm, tn=tn, backend="pallas", device="cuda")
    torch.cuda.synchronize()
    check(res.stats["backend"] == "pallas", "pair backend not taken")
    _launched(f"pair {shape}", required=(w,))
    _check_exact(f"pair {shape} integer", c, ref)
    entry = {"launches": w.kernel_launches}
    sched = res.schedule
    del c, res
    at, bt = csr_to_tiles(a, tm, tn), csr_to_tiles(a, tn, tn)
    ops = _pair_operands(at, bt, sched, "cuda", torch.bfloat16)
    kw = dict(num_segments=sched.nt_c)
    gv, gc = w(*ops, **kw)
    products = float(sched.num_pairs) * tm * tn * tn
    bnd = bound(f"pair_accumulate {shape}", ops, (gv, gc),
                _f32_mma_ops(products) + [(2 * products, "bf16")])
    del gv, gc
    _chunk_time(f"pair {shape}", entry,
                cuda_event_ms(lambda: w(*ops, **kw), warmup=3, iters=20), bnd,
                base_ms["pair_accumulate"], _shape(TM, TN))
    out["pair_accumulate"][shape] = entry
    del ops
    torch.cuda.empty_cache()

    # the f64 Ozaki kernel through the f64 auto route
    tm, tn = OZ_BIG
    shape = _shape(tm, tn)
    oz = ok.ozaki_strip_numeric
    _zero_counters(*_all_wrappers())
    c, res = spgemm_csr(ag, tm=tm, tn=tn, compute_dtype=torch.float64,
                        device="cuda")
    torch.cuda.synchronize()
    print(f"phase tiles: f64 cant-like Gaussian {shape} backend="
          f"{res.stats['backend']} timings_ms={res.timings_ms}")
    check(res.stats["backend"] == "ozaki-strip(S=8x8)",
          f"the f64 route at {shape} picked {res.stats['backend']}")
    _launched(f"ozaki {shape}", required=(oz,))
    entry = {"launches": oz.kernel_launches}
    got = golden.drop_explicit_zeros(c)
    pat = got.pattern_equal(ref_g)
    scale = float(np.abs(ref_g.data).max())
    err = float(np.abs(got.data - ref_g.data).max()) if pat else float("inf")
    print(f"phase check: f64 {shape} pattern_equal={pat} max_abs_err={err!r} "
          f"err/max|C|={err / scale!r} (limit {OZ_RTOL})")
    check(pat and err <= OZ_RTOL * scale, f"f64 {shape} differs from scipy")
    plan = res.schedule
    del c, got, res
    _zero_counters(*_all_wrappers())
    ires = spgemm(csr_to_tiles(a, tm, tn), csr_to_tiles(a, tn, tn),
                  backend="ozaki", device="cuda")
    check(ires.stats["backend"] == "ozaki-strip(S=1x1)",
          f"integer model at {shape}: {ires.stats['backend']}")
    _launched(f"ozaki {shape} integer", required=(oz,))
    _check_exact(f"ozaki {shape} integer", ires.c.to_csr(), ref)
    del ires
    ops = plan.to_device("cuda")
    kw = plan.kernel_kwargs()
    planes = oz(*ops, **kw)
    s = plan.sargs
    kept = sum(1 for i in range(plan.sa) for j in range(plan.sb)
               if i + j <= plan.pmax)
    macs = float(s.num_pairs) * kept * tm * s.tk * s.tn
    bnd = bound(f"ozaki_strip {shape}", ops, planes, [(2 * macs, "int8")])
    del planes
    _chunk_time(f"ozaki {shape}", entry,
                cuda_event_ms(lambda: oz(*ops, **kw), warmup=3, iters=20),
                bnd, base_ms["ozaki_strip"], _shape(OZ_TM, TN))
    out["ozaki_strip"][shape] = entry
    del ops, plan
    torch.cuda.empty_cache()

    # SpMM and SpMV on banded65536
    tm, tn = SPMM_BIG
    shape = _shape(tm, tn)
    sw = smk.spmm_strip
    t = csr_to_tiles(banded, tm, tn)
    sp_a = _sp(banded)
    rng = np.random.default_rng(43)
    block_rows = 64
    stats = pspmm._spmm_block_stats(t, block_rows)
    for label, k, form, vec in (("resident", SPMM_K, "resident", False),
                                ("spmv", 1, "resident", True),
                                ("window", 2 * SPMM_K, "window", False)):
        x = rng.standard_normal(banded.n if vec else (banded.n, k)) \
            .astype(np.float32)
        k_pad = max(128, -(-k // 128) * 128)
        mode = pspmm._spmm_mode(t, k_pad, device=torch.device("cuda"))[0]
        check(mode == form, f"{label} at {shape}: the gate picked {mode}")
        _zero_counters(*_all_wrappers())
        with _RouteSpy() as spy:
            y = (spmv if vec else spmm)(t, x, device="cuda")
            torch.cuda.synchronize()
        ok_, err, scale = _close(y, sp_a @ x.astype(np.float64))
        print(f"phase tiles: spmm banded{SUITE_N} {shape} {label} k={k} "
              f"route={spy.log} max_abs_err={err!r} max|Y|={scale!r} ok={ok_}")
        check(spy.log == ["_spmm_strip"], f"{label} took route {spy.log}")
        _launched(f"spmm {shape} {label}", required=(sw,))
        check((sw.narrow_launches > 0) == vec,
              f"{label}: narrow launches {sw.narrow_launches}")
        check(ok_, f"spmm {shape} {label} differs from scipy: {err}")
        entry = {"launches": sw.kernel_launches}
        del y
        x2 = x[:, None] if vec else x
        ops, smap = _spmm_ops(t, x2, smk.pack_width(k), block_rows)
        km = (None if label != "window" else
              torch.from_numpy(pspmm._window_kmin(t, stats)).to("cuda"))
        kw = dict(gm=t.gm, block_rows=block_rows, smap=smap)
        got = sw(*ops, km, **kw)
        width = got.shape[2]
        bnd = (spmv_bound(f"spmm {shape} {label}", t, ops, smap, got) if vec
               else bound(f"spmm {shape} {label} width={width}", (*ops, km),
                          (got,),
                          _f32_mma_ops(float(t.nt) * t.tm * t.tn * width)))
        del got
        _chunk_time(f"spmm {shape} {label}", entry,
                    cuda_event_ms(lambda: sw(*ops, km, **kw), warmup=3,
                                  iters=20), bnd, base_ms[f"spmm {label}"],
                    _shape(SPMM_TM, TN))
        out["spmm_strip"][f"{shape} {label}"] = entry
        del ops
    torch.cuda.empty_cache()
    return out


# --- phases 38-39: the dynamic-gather kernel and the three probes -----------
# the gather kernel's shapes beyond the probe's nine: C = 1,024 on both axes
GATHER_EXTRA = (("lane gather (16384,1024) blk=256 idx<1024",
                 (16384, 1024), 1, 256, 1024),
                ("sublane gather (16384,1024) blk=512 idx<512",
                 (16384, 1024), 0, 512, 512))
GATHER_MAIN = "lane gather big (131072,128) blk=1024"   # the probe's largest
F_SYMBOLIC = 400_458_682        # rmat65536 A^2's products (phase 7's F)


def compare_gather_kernel() -> dict:
    """Phase 38: take_along_blocks against its plain version, bit-equal,
    at the probe's nine shapes and GATHER_EXTRA; then the kernels JSON
    entry's times at GATHER_MAIN (without launches, which phase 39
    counts)."""
    import torch

    from spgemm_tpu_torch.ops import gather_kernels as gk
    from spgemm_tpu_torch.tools.probe_dyngather import CASES, case_inputs
    from spgemm_tpu_torch.utils.timing import cuda_event_ms, profiler_device_ms

    t0 = time.perf_counter()
    held, entry = [], None
    for name, shape, axis, blk, idx_max in CASES + GATHER_EXTRA:
        x, idx = case_inputs(shape, idx_max)
        xd = torch.from_numpy(x).to("cuda")
        idd = torch.from_numpy(idx).to("cuda")
        kw = dict(axis=axis, blk_rows=blk)
        got = gk.take_along_blocks(xd, idd, **kw)
        exp = gk.take_along_blocks_plain(xd, idd, **kw)
        torch.cuda.synchronize()
        equal = torch.equal(got, exp)
        err = (got - exp).abs().max().item()
        print(f"phase gather-compare: {name} axis={axis} bit_equal={equal} "
              f"max_abs_err={err!r}")
        check(equal, f"the gather kernel differs from its plain version: "
                     f"{name}")
        held.append(f"{shape[0]}x{shape[1]} axis {axis} blk {blk}")
        if name != GATHER_MAIN:
            continue
        view = (shape[0] // blk, blk, shape[1])
        xv, iv = xd.view(view), idd.long().view(view)
        ms = cuda_event_ms(lambda: gk.take_along_blocks(xd, idd, **kw),
                           warmup=3, iters=50)
        dev_ms = profiler_device_ms(lambda: gk.take_along_blocks(xd, idd,
                                                                 **kw))
        plain_ms = cuda_event_ms(lambda: gk.take_along_blocks_plain(
            xd, idd, **kw), warmup=2, iters=20)
        lib_ms = library_ms(f"torch.gather on the blocked view, {name}",
                            lambda: torch.gather(xv, axis + 1, iv), iters=50)
        lib_dev_ms = profiler_device_ms(lambda: torch.gather(xv, axis + 1,
                                                             iv))
        b_ms, b_by = bound(f"take_along_blocks {name}", (xd, idd), (got,))
        print(f"{CARD} | phase gather-time: {name} kernel_ms={ms!r} "
              f"device_ms={dev_ms!r} plain_ms={plain_ms!r} "
              f"library_ms={lib_ms!r} library_device_ms={lib_dev_ms!r} "
              f"bound_ms={b_ms!r}")
        check(dev_ms > 0, "torch.profiler read no device time for the "
                          "gather kernel")
        entry = dict(
            name="take_along_blocks", route="cuda",
            source="spgemm_tpu_torch/csrc/dyngather.cu",
            replaces="tools/probe_dyngather.py:40", max_abs_err=err, ms=ms,
            device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms, library_device_ms=lib_dev_ms,
            shape=f"{shape[0]}x{shape[1]} axis {axis} blk {blk}")
        del xv, iv
    entry["tiles"] = held
    time_rounding_probe()
    print(f"phase gather-compare: took {time.perf_counter() - t0!r} s")
    return entry


def time_rounding_probe() -> None:
    """The other TPU kernel of tools/ (verify_tpu.py:188, the Mosaic
    TwoSum probe) has its counterpart in csrc/twosum_probe.cu, which
    verify_cuda runs on 1,024 elements (phase 34): its time there beside
    its bound. No PyTorch call computes it."""
    import torch

    from spgemm_tpu_torch.ops import ozaki_kernels
    from spgemm_tpu_torch.tools.verify_cuda import rounding_probe_launcher
    from spgemm_tpu_torch.utils.timing import cuda_event_ms, profiler_device_ms

    launch = rounding_probe_launcher(ozaki_kernels.NVCC_FLAGS)
    x = torch.ones(8 * 128, dtype=torch.float32, device="cuda")
    ts, ce = torch.empty_like(x), torch.empty_like(x)
    ms = cuda_event_ms(lambda: launch(x, ts, ce), warmup=3, iters=50)
    dev_ms = profiler_device_ms(lambda: launch(x, ts, ce))
    b_ms, b_by = bound("twosum_probe n=1024", (x,), (ts, ce))
    print(f"{CARD} | phase gather-time: twosum_probe n={x.numel()} "
          f"kernel_ms={ms!r} device_ms={dev_ms!r} bound_ms={b_ms!r} "
          f"({b_by}); library_ms none")


def _probe_file(path: str, rows: int) -> list:
    """The probe's results file: its first line the card's, `rows` lines
    after it that are not FAILED."""
    with open(path) as f:
        lines = f.read().splitlines()
    print(f"phase probes: {os.path.basename(path)} {len(lines)} lines")
    check(lines and lines[0] == CARD,
          f"{path} does not start with the card's line: {lines[:1]}")
    bad = [ln for ln in lines if "FAILED" in ln]
    check(not bad and len(lines) >= rows + 1, f"{path}: {bad or lines}")
    return lines


def run_probe_phases() -> int:
    """Phase 39: the three probes through their entry points, writing into
    a temporary directory. Returns take_along_blocks' launches in the
    dynamic-gather probe's process."""
    from spgemm_tpu_torch.ops import gather_kernels as gk

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "probe_dyngather.txt")
        _, _, counts = run_tool("probe-dyngather",
                                "spgemm_tpu_torch.tools.probe_dyngather",
                                ["--out", path],
                                required=(gk.take_along_blocks,))
        cases = _probe_file(path, 9)[1:]
        check(len(cases) == 9 and all("ok=True" in ln for ln in cases),
              f"a dynamic-gather case is not ok: {cases}")
        path = os.path.join(d, "probe_sort.txt")
        run_tool("probe-sort", "spgemm_tpu_torch.tools.probe_sort",
                 ["--out", path])
        lines = _probe_file(path, 15)
        big = [i for i, ln in enumerate(lines)
               if ln.startswith(f"F={F_SYMBOLIC}")]
        check(len(big) == 1 and all(" ms " in ln for ln in
                                     lines[big[0] + 1: big[0] + 4]),
              f"probe_sort lacks the F={F_SYMBOLIC} sort rows")
        path = os.path.join(d, "probe_primitives.txt")
        run_tool("probe-primitives", "spgemm_tpu_torch.tools.probe_primitives",
                 ["--out", path])
        _probe_file(path, 10)
    launches = counts[gk.take_along_blocks.__name__][0]
    print(f"{CARD} | phase probes: phase 39 took "
          f"{time.perf_counter() - t_all!r} s; take_along_blocks launched "
          f"{launches} times")
    return launches


def run() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.models.csr import flop_count_spgemm
    from spgemm_tpu_torch.ops import golden, kernels
    from spgemm_tpu_torch.ops.executor import StripExecutor
    from spgemm_tpu_torch.ops.gustavson import run_strip_symbolic
    from spgemm_tpu_torch.ops.spgemm import spgemm_csr
    from spgemm_tpu_torch.utils import generators as pgen
    from spgemm_tpu_torch.utils.generators import cantlike
    from spgemm_tpu_torch.utils.timing import (card_line, cuda_event_ms,
                                               profiler_device_ms)

    global CARD
    CARD = card_line()
    print(CARD)
    dev_name = torch.cuda.get_device_name(0)
    print(f"phase device: {dev_name} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    build_kernels()

    compare_random_plans()

    # --- phase 4: the main path -------------------------------------
    a = cantlike(ROWS, BAND)
    nnz_cub = flop_count_spgemm(a, a)
    print(f"phase main: cant-like {ROWS}x{ROWS} nnz={a.nnz} "
          f"nnzCub={nnz_cub} tiles A {TM}x{TN}, B {TN}x{TN}")
    kernels.strip_numeric.kernel_launches = 0
    kernels.strip_numeric.plain_launches = 0
    t0 = time.perf_counter()
    c, res = spgemm_csr(a, tm=TM, tn=TN, device="cuda")
    csr_s = time.perf_counter() - t0
    at = csr_to_tiles(a, TM, TN)
    bt = csr_to_tiles(a, TN, TN)
    ex = StripExecutor(at, bt, device="cuda")
    c_ex = ex.run_compact().to_csr()
    torch.cuda.synchronize()
    launches = kernels.strip_numeric.kernel_launches
    plain_launches = kernels.strip_numeric.plain_launches
    sa = ex.args
    print(f"phase main: spgemm_csr {csr_s!r} s, backend="
          f"{res.stats['backend']}, plan ntA={at.nt} ntB={bt.nt} "
          f"gm={sa.gm} gk={at.gn} kwin={sa.kwin} max_b={sa.max_b} "
          f"max_ablock={sa.max_ablock} max_cblock={sa.max_cblock} "
          f"nt_c={sa.nt_c} pairs={sa.num_pairs} padded_slots="
          f"{-(-sa.gm // sa.block_rows) * sa.max_cblock}")
    print(f"phase main: launches kernel={launches} plain={plain_launches}")
    check(launches >= 2, "the main path did not launch the strip kernel")
    check(plain_launches == 0, "the main path ran the plain version")

    ref = golden.spgemm_scipy(a, a)
    cant_nnz_c = ref.nnz
    for label, got in (("spgemm_csr", c), ("StripExecutor", c_ex)):
        got = golden.drop_explicit_zeros(got)
        pat = got.pattern_equal(ref)
        exact = pat and np.array_equal(got.data, ref.data)
        print(f"phase check: {label} nnzC={got.nnz} oracle nnzC={ref.nnz} "
              f"pattern_equal={pat} values_exact={exact}")
        check(pat and exact, f"{label} result differs from the scipy oracle")

    # --- phase 5: timings at the main path's plan --------------------
    sym_ms = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        run_strip_symbolic(at, bt, sa.block_rows, sa.max_b, sa.max_ablock)
        sym_ms = min(sym_ms, (time.perf_counter() - t0) * 1e3)
    ops = sa.to_device("cuda")
    kw = sa.kernel_kwargs()
    cv, cc = kernels.strip_numeric(*ops, **kw)
    pv, pc = kernels.strip_numeric_plain(*ops, **kw)
    torch.cuda.synchronize()
    max_abs_err = (cv - pv).abs().max().item()
    check(max_abs_err == 0.0 and torch.equal(cc, pc),
          f"kernel and plain differ on the main plan: {max_abs_err}")
    products = float(sa.num_pairs) * sa.tm * sa.tk * sa.tn
    strip_bound = bound("strip_numeric (values and counts)", ops, (cv, cc),
                        _f32_mma_ops(products) + [(2 * products, "bf16")])
    del cv, cc, pv, pc
    numeric_ms = ex.time_numeric(warmup=5, iters=50)
    device_ms = profiler_device_ms(lambda: kernels.strip_numeric(*ops, **kw))
    plain_ms = cuda_event_ms(
        lambda: kernels.strip_numeric_plain(*ops, **kw), warmup=2, iters=10)
    gflops = 2.0 * nnz_cub / ((sym_ms + numeric_ms) * 1e6)
    print(f"{CARD} | phase time: symbolic_ms={sym_ms!r} "
          f"numeric_ms={numeric_ms!r} (CUDA events) device_ms={device_ms!r} "
          f"(torch.profiler) plain_numeric_ms={plain_ms!r} "
          f"bound_ms={strip_bound[0]!r} ({strip_bound[1]}; "
          f"{100.0 * strip_bound[0] / numeric_ms!r}% of the kernel's time) "
          f"gflops={gflops!r} (2*nnzCub/(symbolic+numeric); reference GPU "
          f"bar 52.63)")
    usage = kernels.ptxas_usage(kernels.build_info["ptxas"])
    for fn, (regs, spill_st, spill_ld) in sorted(usage.items()):
        print(f"phase time: ptxas {fn}: {regs} registers, {spill_st} bytes "
              f"spill stores, {spill_ld} bytes spill loads")
    tm64 = [u for fn, u in usage.items() if "strip_numeric_kernelILi64E" in fn]
    check(len(tm64) == 1 and tm64[0][0] <= 168 and tm64[0][1:] == (0, 0),
          f"the 64x128 strip kernel needs <= 168 registers at launch and no "
          f"spills for one 384-thread CTA per SM: {tm64}")
    a_t = _torch_csr(a, torch.float32)
    strip_lib_ms = library_ms("torch.sparse.mm(A_csr, A_csr) f32 at the "
                              "cant-like", lambda: torch.sparse.mm(a_t, a_t),
                              iters=3)
    del a_t
    # the same kernel on the cached-B plan shape (window=False), which
    # stands in for the TPU's _strip_kernel_factory
    from spgemm_tpu_torch.ops.gustavson import build_strip_args
    nw = build_strip_args(at, bt, window=False)
    nw_ops = nw.to_device("cuda")
    nw_kw = nw.kernel_kwargs()
    cv, cc = kernels.strip_numeric(*nw_ops, **nw_kw)
    pv, pc = kernels.strip_numeric_plain(*nw_ops, **nw_kw)
    torch.cuda.synchronize()
    check(torch.equal(cv, pv) and torch.equal(cc, pc),
          "kernel and plain differ on the window=False plan")
    del cv, cc, pv, pc
    nw_ms = cuda_event_ms(lambda: kernels.strip_numeric(*nw_ops, **nw_kw),
                          warmup=3, iters=20)
    nw_plain_ms = cuda_event_ms(
        lambda: kernels.strip_numeric_plain(*nw_ops, **nw_kw), warmup=1,
        iters=5)
    print(f"phase time: window=False plan (kwin={nw.kwin} max_b={nw.max_b} "
          f"max_cblock={nw.max_cblock}) kernel_ms={nw_ms!r} "
          f"plain_ms={nw_plain_ms!r}, equal to the plain version")
    del nw_ops
    # the same plan with Gaussian values: no operand is a TF32 value, so
    # every k step takes the exact three-way split (six products, not one)
    ag = a.with_data(np.random.default_rng(0).standard_normal(a.nnz))
    gs = build_strip_args(csr_to_tiles(ag, TM, TN), csr_to_tiles(ag, TN, TN))
    g_ops = gs.to_device("cuda")
    g_kw = gs.kernel_kwargs()
    cv, cc = kernels.strip_numeric(*g_ops, **g_kw)
    pv, pc = kernels.strip_numeric_plain(*g_ops, **g_kw)
    torch.cuda.synchronize()
    g_err = (cv - pv).abs().max().item()
    g_scale = pv.abs().max().item()
    g_ok = torch.allclose(cv, pv, rtol=GAUSS_RTOL, atol=1e-6 * g_scale)
    g_cnt = torch.equal(cc, pc)
    del cv, cc, pv, pc
    check(g_ok and g_cnt, f"kernel and plain differ on the Gaussian main "
                          f"plan: max_abs_err {g_err}, counts equal {g_cnt}")
    g_ms = cuda_event_ms(lambda: kernels.strip_numeric(*g_ops, **g_kw),
                         warmup=5, iters=50)
    g_device_ms = profiler_device_ms(
        lambda: kernels.strip_numeric(*g_ops, **g_kw))
    print(f"{CARD} | phase time: Gaussian values on the main plan "
          f"(kwin={gs.kwin} pairs={gs.num_pairs}) kernel_ms={g_ms!r} "
          f"device_ms={g_device_ms!r} (the three-way split on every k "
          f"step) max_abs_err={g_err!r} max_abs={g_scale!r}, counts equal")
    del g_ops
    print(f"phase time: peak device memory "
          f"{torch.cuda.max_memory_allocated()!r} bytes")

    del ex, ops
    torch.cuda.empty_cache()

    compare_scan_kernels()
    run_esc_tiles()
    suite = pgen.suite(SUITE_N)
    esc_entries = run_esc_path(suite)
    torch.cuda.empty_cache()
    dd_entry = run_f64_path(suite)
    torch.cuda.empty_cache()
    compare_spmm_plans()
    spmm_entries = run_spmm_path(suite)
    rnd = suite[f"random{SUITE_N}"]
    rmat = suite[f"rmat{SUITE_N}"]
    band = suite[f"banded{SUITE_N}"]
    del suite
    torch.cuda.empty_cache()

    compare_ozaki_plans()
    oz_entry = run_ozaki_path(a, ref)
    torch.cuda.empty_cache()
    run_ozaki_passes_phase()
    torch.cuda.empty_cache()
    run_pick_phase()
    torch.cuda.empty_cache()

    compare_pair_plans()
    pair_entry = run_pair_path(a, ref, strip_lib_ms)
    torch.cuda.empty_cache()
    # phase 38 runs here: after the multi-device phases torch.profiler
    # reads no device time on the card
    gather_entry = compare_gather_kernel()
    torch.cuda.empty_cache()

    ag, ref_g = run_gustavson_route(a, ref)
    run_dense_route()
    run_slab_f64_route(ag, ref_g)
    torch.cuda.empty_cache()
    run_example_phases(rnd)
    del rnd
    torch.cuda.empty_cache()
    run_dist_one_rank(rmat)
    del rmat
    run_dist_two_ranks()
    run_dryrun_phase()
    run_tool_phases(cant_nnz_c, numeric_ms)

    # phases 36-37: the kernels at tile shapes past their instantiations
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    held = compare_tile_shapes()
    base_ms = {"strip_numeric": numeric_ms, "pair_accumulate":
               pair_entry["ms"], "ozaki_strip": oz_entry["ms"]}
    for e, label in zip(spmm_entries, ("resident", "spmv", "window")):
        base_ms[f"spmm {label}"] = e["ms"]
    chunked = run_tile_shapes_phase(a, ref, ag, ref_g, band, base_ms)
    print(f"phase tiles: phases 36-37 took {time.perf_counter() - t0!r} s")
    del a, ref, ag, ref_g, band
    torch.cuda.empty_cache()

    # phase 39: the three probes
    gather_entry["launches"] = run_probe_phases()
    # the tile shapes each kernel was held at against its plain version
    # (phases 3, 10, 13, 16 and 36) and its chunked times (phase 37)
    instantiated = {"strip_numeric": ["64x128", "16x128"],
                    "pair_accumulate": ["16x128", "64x128"],
                    "ozaki_strip": ["16x128", "32x128"],
                    "spmm_strip": ["16x128", "64x128"]}
    entries = [{
            "name": "strip_numeric",
            "route": "cuda",
            "source": "spgemm_tpu_torch/csrc/strip_numeric.cu",
            "replaces": "spgemm_tpu/ops/pallas_kernels.py:406",
            "also_replaces": "spgemm_tpu/ops/pallas_kernels.py:219",
            "launches": launches,
            "max_abs_err": max_abs_err,
            "ms": numeric_ms,
            "device_ms": device_ms,
            "plain_ms": plain_ms,
            "bound_ms": strip_bound[0],
            "bound_by": strip_bound[1],
            "library_ms": strip_lib_ms,
            "gaussian_ms": g_ms,
            "gaussian_device_ms": g_device_ms,
            "gaussian_max_abs_err": g_err,
            "registers": tm64[0][0],
        }] + esc_entries + [dd_entry, oz_entry] + spmm_entries + [
            pair_entry, gather_entry]
    for e in entries:
        key = "spmm_strip" if e["name"].startswith("spmm_strip") \
            else e["name"]
        if key in held:
            e["tiles"] = instantiated[key] + held[key]
            e["chunked"] = chunked[key]
    return {
        "kernels": entries,
        # the number of cards this run uses
        "device": {"platform": "gpu", "kind": dev_name, "count": 1},
    }


def main() -> int:
    try:
        out = run()
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              "repository root", file=sys.stderr)
        return 1
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": out["device"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
