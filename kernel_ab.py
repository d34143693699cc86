"""A/B timing of the port's hand-written kernels on one CUDA card: this
checkout's sources against another revision's.

    git archive <rev> spgemm_tpu_torch/csrc | tar -x -C _checkout/parent
    python3 kernel_ab.py _checkout/parent/spgemm_tpu_torch/csrc

Both revisions' `ozaki_strip.cu`, `esc_scan.cu`, `strip_numeric.cu`,
`pair_accumulate.cu` and `spmm_strip.cu` are built with the port's nvcc
flags (one nvcc per source and side, all started together) and driven on
the main plans of `chip_smoke.py`: the cant-like 62,451^2 A^2 with
standard-normal values at 32x128 tiles (the Ozaki kernel), the suite's
rmat65536 A^2 (premul and mul), random65536 with standard-normal values
(double-double), the cant-like A^2 at 64x128 with integer values (the
strip kernel, and the pair kernel on the pair schedule with the bfloat16
occupancy the pair backend uploads; both also with standard-normal
values), and the suite's banded65536 at 16x128 tiles with standard-normal
X, then with integer A and X, at k = 128 (resident form) and k = 256
(window form; the SpMM kernel's 128-column form). The port's wrapper
drives either side's library (both share a C interface; the pair
kernel's is the one since its tensor-core redesign, which exports
`pair_accumulate_abi`). For the strip, pair and 128-column SpMM kernels
it also prints each side's worst error on long sums of positive products
against the f64 product. Each kernel is first checked against its plain
version (bit-equal with torch.equal, or with standard-normal values
within rtol 1e-5, atol 1e-6*max|C|), then timed with CUDA events (median
of 20 calls after 3 warm-up calls) in the order base, new, new, base,
base, new, so that both sides see the same card in turns.
Prints the card's name and power limit, each build's ptxas registers and
spills, every timing, and last one JSON line {"<kernel>": {"base": [...],
"new": [...]}}. Exits 1 without CUDA or on any disagreement.
"""

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

ORDER = ("base", "new", "new", "base", "base", "new")


def _build(src, stem, flags, bind):
    from spgemm_tpu_torch.ops import kernels

    lib, info = kernels.build_cuda_library(src, stem, flags)
    bind(lib)
    return lib, info


def _build_all(jobs):
    """jobs {key: (src, stem, flags, bind)} -> {key: lib}, one nvcc per
    job, all started together; prints each build's ptxas report."""
    from concurrent.futures import ThreadPoolExecutor

    from spgemm_tpu_torch.ops import kernels

    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {k: pool.submit(_build, *job) for k, job in jobs.items()}
        built = {k: f.result() for k, f in futs.items()}
    for (src, stem, _, _), (_, info) in zip(jobs.values(), built.values()):
        for fn, (regs, st, ld) in sorted(
                kernels.ptxas_usage(info["ptxas"]).items()):
            print(f"ptxas {stem} {fn}: {regs} registers, {st} bytes spill "
                  f"stores, {ld} bytes spill loads")
    return {k: lib for k, (lib, _) in built.items()}


def _bind_ozaki(lib):
    lib.ozaki_strip_f32.argtypes = ([ctypes.c_void_p] * 11
                                    + [ctypes.c_int64] * 12
                                    + [ctypes.c_void_p])
    lib.ozaki_strip_f32.restype = ctypes.c_int


def _bind_scan(lib):
    for name, n_ptr in (("esc_scan_f32", 3), ("esc_scan_mul_f32", 4),
                        ("esc_scan_dd_f32", 5)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int


def _bind_strip(lib):
    lib.strip_numeric_f32.argtypes = ([ctypes.c_void_p] * 9
                                      + [ctypes.c_int64] * 8
                                      + [ctypes.c_void_p])
    lib.strip_numeric_f32.restype = ctypes.c_int


def _bind_spmm(lib):
    lib.spmm_strip_f32.argtypes = ([ctypes.c_void_p] * 6
                                   + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
    lib.spmm_strip_f32.restype = ctypes.c_int


def _bind_pair(lib):
    lib.pair_accumulate_f32.argtypes = ([ctypes.c_void_p] * 9
                                        + [ctypes.c_int64] * 5
                                        + [ctypes.c_void_p])
    lib.pair_accumulate_f32.restype = ctypes.c_int


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _swap(module, lib, fn):
    """fn run with `module`'s loaded library swapped for `lib`."""
    def call():
        module._lib = lib
        return fn()
    return call


def _agree(got, exp, close):
    import torch

    if not close:
        return all(torch.equal(g, e) for g, e in zip(got, exp))
    scale = max(e.abs().max().item() for e in exp)
    return all(torch.allclose(g, e, rtol=1e-5, atol=1e-6 * scale)
               for g, e in zip(got, exp))


def _ab(label, calls, plain, close=False):
    """Check each side's result against the plain version's (bit-equal,
    or within rtol 1e-5 with `close`), then time them in ORDER. `calls`
    maps "base" and "new" to a no-argument launch. Returns {"base": [...],
    "new": [...]}."""
    import torch

    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    exp = _tuple(plain())
    for side, call in calls.items():
        got = _tuple(call())
        torch.cuda.synchronize()
        ok = _agree(got, exp, close)
        print(f"{label}: {side} {'close' if close else 'bit_equal'}={ok}")
        if not ok:
            raise SystemExit(f"{label}: the {side} kernel differs from its "
                             f"plain version")
        del got
    del exp
    torch.cuda.empty_cache()
    times = {"base": [], "new": []}
    for side in ORDER:
        times[side].append(cuda_event_ms(calls[side], warmup=3, iters=20))
    print(f"{label}: ms {times}")
    return times


def _long_sums(libs) -> None:
    """Prints each side's worst error on long sums of positive products,
    max |C - C64| / (1e-5 |C64| + 1e-6 max|C64|) against the f64 product
    of the f32-rounded operands (above 1 misses rtol 1e-5), for the strip
    and pair kernels on C = A (256 x 4096) times B (4096 x 256) at 30%
    density with uniform values (about 370 products over 512 mma steps per
    entry), and for SpMM's 128-column form on Y = A X with a uniform X at
    k = 128, resident, and 256, windowed (about 1,230 products per
    entry). `libs` maps (kernel, side) to a library."""
    import torch

    import spgemm_tpu_torch as pt
    from spgemm_tpu_torch.ops import kernels
    from spgemm_tpu_torch.ops import pair_kernels as pk
    from spgemm_tpu_torch.ops import spmm as pspmm
    from spgemm_tpu_torch.ops import spmm_kernels as smk

    rng = np.random.default_rng(21)
    mk = lambda m, n: rng.random((m, n)) * (rng.random((m, n)) < 0.3)
    f32 = lambda v: v.astype(np.float32).astype(np.float64)
    a, b = mk(256, 4096), mk(4096, 256)
    a_csr, b_csr = pt.CSR.from_dense(a), pt.CSR.from_dense(b)
    worst = lambda got, ref: float((np.abs(got - ref) / (
        1e-5 * np.abs(ref) + 1e-6 * np.abs(ref).max())).max())
    ref = f32(a) @ f32(b)
    at, bt = pt.csr_to_tiles(a_csr, 16, 128), pt.csr_to_tiles(b_csr, 128, 128)
    for name, mod, backend in (("strip_numeric", kernels, "strip"),
                               ("pair_accumulate", pk, "pallas")):
        for side in ("base", "new"):
            mod._lib = libs[name, side]
            got = pt.spgemm(at, bt, backend=backend, device="cuda").c
            print(f"{name} long positive sums: {side} worst error / "
                  f"(1e-5|C| + 1e-6 max|C|) = "
                  f"{worst(got.to_csr().to_dense(), ref)!r}")
    t = pt.csr_to_tiles(a_csr, 16, 128)
    stats = pspmm._spmm_block_stats(t, 8)
    km = torch.from_numpy(pspmm._window_kmin(t, stats)).to("cuda")
    for k, form in ((128, None), (256, km)):
        x = np.random.default_rng(22).random((4096, k))
        ops = pspmm._pack_spmm_operands(t, x, k, torch.float32,
                                        8).to_device("cuda")
        ref = f32(a) @ f32(x)
        for side in ("base", "new"):
            smk._lib = libs["spmm_strip", side]
            y = smk.spmm_strip(*ops, form, gm=t.gm, block_rows=8)
            got = y.reshape(-1, k)[:256].double().cpu().numpy()
            print(f"spmm_strip k {k} long positive sums: {side} worst error"
                  f" / (1e-5|Y| + 1e-6 max|Y|) = {worst(got, ref)!r}")


def main(base_dir: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import kernels
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops import pair_kernels as pk
    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops import spmm as pspmm
    from spgemm_tpu_torch.ops import spmm_kernels as smk
    from spgemm_tpu_torch.ops.esc import (build_esc_scan_plan,
                                          choose_group_rows, gather_planes,
                                          scan_dd_planes)
    from spgemm_tpu_torch.ops.gustavson import build_strip_args
    from spgemm_tpu_torch.ops.ozaki import build_ozaki_strip
    from spgemm_tpu_torch.ops.symbolic import build_pair_schedule
    from spgemm_tpu_torch.utils.generators import cantlike, suite

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    jobs = {}
    for name, mod, bind in (
            ("ozaki_strip", ok, _bind_ozaki),
            ("esc_scan", sk, _bind_scan),
            ("strip_numeric", kernels, _bind_strip),
            ("pair_accumulate", pk, _bind_pair),
            ("spmm_strip", smk, _bind_spmm)):
        jobs[name, "base"] = (os.path.join(base_dir, name + ".cu"),
                              f"lib{name}_base", mod.NVCC_FLAGS, bind)
        jobs[name, "new"] = (mod.KERNEL_SRC, f"lib{name}_new",
                             mod.NVCC_FLAGS, bind)
    libs = _build_all(jobs)
    sides = lambda name: {side: libs[name, side] for side in ("base", "new")}
    out = {}

    a0 = cantlike(62451, 64)
    a = a0.with_data(np.random.default_rng(0).standard_normal(a0.nnz))
    plan = build_ozaki_strip(csr_to_tiles(a, 32, 128),
                             csr_to_tiles(a, 128, 128), strict=True)
    s = plan.sargs
    print(f"ozaki plan: S={plan.sa}x{plan.sb} pmax={plan.pmax} av8="
          f"{plan.av8.shape} bv8={plan.bv8.shape} max_b={s.max_b} "
          f"max_cblock={s.max_cblock} pairs={s.num_pairs}")
    ops = plan.to_device("cuda")
    kw = plan.kernel_kwargs()
    run = lambda: ok.ozaki_strip_numeric(*ops, **kw)
    out["ozaki_strip"] = _ab(
        "ozaki_strip cant-like tm 32",
        {side: _swap(ok, lib, run) for side, lib in sides("ozaki_strip").items()},
        lambda: ok.ozaki_strip_numeric_plain(*ops, **kw))
    del ops, plan, run
    torch.cuda.empty_cache()

    mats = suite(65536)
    r0 = mats["random65536"]
    rg = r0.with_data(np.random.default_rng(23).standard_normal(r0.nnz))
    for name, m, modes in (("rmat65536", mats["rmat65536"],
                            ("esc_scan", "esc_scan_mul")),
                           ("random65536", rg, ("esc_scan_dd",))):
        t0 = time.perf_counter()
        p = build_esc_scan_plan(m, m, group_rows=choose_group_rows(m, m))
        print(f"{name} plan: {time.perf_counter() - t0!r} s R="
              f"{p.qv.shape[0]} G={p.group_rows} passes={p.passes}")
        up = lambda x: torch.from_numpy(x).to("cuda")
        meta = up(p.meta16())
        kw = dict(passes=p.passes, group_rows=p.group_rows)
        make = {"esc_scan": lambda: (up(p.qv),),
                "esc_scan_mul": lambda: tuple(map(up, gather_planes(
                    p, m.data, m.data))),
                "esc_scan_dd": lambda: tuple(map(up, scan_dd_planes(
                    p, m.data, m.data)))}
        for mode in modes:
            w, plain = getattr(sk, mode), getattr(sk, mode + "_plain")
            planes = make[mode]()
            run = lambda: w(*planes, meta, **kw)
            out[mode] = _ab(
                f"{mode} {name}",
                {side: _swap(sk, lib, run)
                 for side, lib in sides("esc_scan").items()},
                lambda: plain(*planes, meta, **kw))
            del planes
        del meta, p
        torch.cuda.empty_cache()

    # the cant-like A^2 at 64x128 with integer values: the strip kernel on
    # the main plan, the pair kernel on the pair schedule
    at, bt = csr_to_tiles(a0, 64, 128), csr_to_tiles(a0, 128, 128)
    args = build_strip_args(at, bt)
    ops = args.to_device("cuda")
    kw = args.kernel_kwargs()
    run = lambda: kernels.strip_numeric(*ops, **kw)
    out["strip_numeric"] = _ab(
        "strip_numeric cant-like tm 64",
        {side: _swap(kernels, lib, run)
         for side, lib in sides("strip_numeric").items()},
        lambda: kernels.strip_numeric_plain(*ops, **kw))
    del ops, args, run
    # the same plan with standard-normal values: every k step takes the
    # 3xTF32 branch
    ag = a0.with_data(np.random.default_rng(0).standard_normal(a0.nnz))
    gargs = build_strip_args(csr_to_tiles(ag, 64, 128),
                             csr_to_tiles(ag, 128, 128))
    gops = gargs.to_device("cuda")
    gkw = gargs.kernel_kwargs()
    grun = lambda: kernels.strip_numeric(*gops, **gkw)
    out["strip_numeric_gaussian"] = _ab(
        "strip_numeric cant-like tm 64 Gaussian",
        {side: _swap(kernels, lib, grun)
         for side, lib in sides("strip_numeric").items()},
        lambda: kernels.strip_numeric_plain(*gops, **gkw), close=True)
    del gops, gargs, grun
    torch.cuda.empty_cache()
    sched = build_pair_schedule(at, bt)
    up = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
    f32_ops = (up(at.dense(np.float32)), up(at.occ()).float(),
               up(bt.dense(np.float32)), up(bt.occ()).float(), up(sched.pa),
               up(sched.pb), up(sched.pair_ptr))
    bf16_ops = (f32_ops[0], f32_ops[1].to(torch.bfloat16), f32_ops[2],
                f32_ops[3].to(torch.bfloat16)) + f32_ops[4:]
    nseg = sched.nt_c
    run = lambda: pk.pair_accumulate_cuda(*bf16_ops, num_segments=nseg)
    out["pair_accumulate"] = _ab(
        f"pair_accumulate cant-like tm 64 ({sched.num_pairs} pairs)",
        {side: _swap(pk, lib, run)
         for side, lib in sides("pair_accumulate").items()},
        lambda: pk.pair_accumulate_plain(*f32_ops, num_segments=nseg))
    # the same schedule with standard-normal values: the split branch
    gat, gbt = csr_to_tiles(ag, 64, 128), csr_to_tiles(ag, 128, 128)
    g_ops = (up(gat.dense(np.float32)),) + bf16_ops[1:2] + (
        up(gbt.dense(np.float32)),) + bf16_ops[3:]
    grun = lambda: pk.pair_accumulate_cuda(*g_ops, num_segments=nseg)
    out["pair_accumulate_gaussian"] = _ab(
        "pair_accumulate cant-like tm 64 Gaussian",
        {side: _swap(pk, lib, grun)
         for side, lib in sides("pair_accumulate").items()},
        lambda: pk.pair_accumulate_plain(*g_ops, num_segments=nseg),
        close=True)
    del f32_ops, bf16_ops, g_ops, grun, ag
    torch.cuda.empty_cache()
    _long_sums(libs)
    torch.cuda.empty_cache()

    # banded65536 at 16x128: k 128 (resident) and 256 (window), with the
    # suite's values and standard-normal X, then integer A and X (the
    # one-product path, bit-equal)
    band = mats["banded65536"]
    t = csr_to_tiles(band, 16, 128)
    t_int = csr_to_tiles(band.with_data(np.random.default_rng(42).integers(
        1, 10, band.nnz).astype(np.float64)), 16, 128)
    block_rows = 64
    stats = pspmm._spmm_block_stats(t, block_rows)
    rng = np.random.default_rng(41)
    for values, tiles in (("", t), (" integer", t_int)):
        for k, form in ((128, "resident"), (256, "window")):
            x = (rng.standard_normal((band.n, k)) if not values else
                 rng.integers(-4, 5, (band.n, k))).astype(np.float32)
            ops = pspmm._pack_spmm_operands(tiles, x, k, torch.float32,
                                            block_rows).to_device("cuda")
            km = (torch.from_numpy(pspmm._window_kmin(t, stats)).to("cuda")
                  if form == "window" else None)
            kw = dict(gm=t.gm, block_rows=block_rows)
            run = lambda: smk.spmm_strip(*ops, km, **kw)
            out[f"spmm_strip_k{k}{values.replace(' ', '_')}"] = _ab(
                f"spmm_strip banded65536 16x128 k {k} {form}{values}",
                {side: _swap(smk, lib, run)
                 for side, lib in sides("spmm_strip").items()},
                lambda: smk.spmm_strip_plain(*ops, km, **kw),
                close=not values)
            del ops, run
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
