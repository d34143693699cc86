"""A/B timing of the port's hand-written kernels on one CUDA card: this
checkout's sources against another revision's.

    git archive <rev> spgemm_tpu_torch/csrc | tar -x -C _checkout/parent
    python3 kernel_ab.py _checkout/parent/spgemm_tpu_torch/csrc
    python3 kernel_ab.py <csrc dir> --only spmm_strip   # one source's rows

The other side may also be an edited copy of this checkout's csrc (a
design variant), compared on the same rows.

Both revisions' `ozaki_strip.cu`, `esc_scan.cu`, `strip_numeric.cu`,
`pair_accumulate.cu` and `spmm_strip.cu` are built with the port's nvcc
flags (one nvcc per source and side, all started together) and driven on
the main plans of `chip_smoke.py`: the cant-like 62,451^2 A^2 with
standard-normal values at 32x128 tiles (the Ozaki kernel), the suite's
rmat65536 A^2 (premul and mul), random65536 with standard-normal values
(double-double), the cant-like A^2 at 64x128 with integer values (the
strip kernel, and the pair kernel on the pair schedule with the bfloat16
occupancy the pair backend uploads; both also with standard-normal
values; the strip kernel also at 32x128, 16x128 and 8x128), and the
suite's banded65536 at 16x128 and 64x128 tiles with standard-normal X,
then with integer A and X, at k = 128 (resident form) and k = 256 (window
form; the SpMM kernel's 128-column form), and at 16x128 at k = 1 packed
at width 8 (SpMV, the
narrow form; device time by torch.profiler, as the call is shorter than a
launch), then the new side alone at width 1, SpMV's width since the
redesign. The port's wrapper drives the new side's library and every
library whose C interface both sides share; the Ozaki and SpMM sources
took new interfaces with their redesign for Hopper (the Ozaki kernel's
K-major scratch for B, the narrow form's sector map), so a base side
built from a source of before it is driven through its own interface
(`_ozaki_old`, `_spmm_old`), on the same device tensors. The strip and
pair sources kept their C interfaces when their shared pipeline moved to
TMA and wgmma, so both sides of those run through the wrapper. For the
strip, pair and 128-column SpMM kernels
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


# a word only the current C interfaces of the Ozaki and SpMM sources
# name; a source without it is on the interface before their redesign
NEW_ABI_MARK = {"ozaki_strip": "bt_occ", "spmm_strip": "smap"}


def _old_abi(name, src):
    return name in NEW_ABI_MARK and NEW_ABI_MARK[name] not in open(src).read()


def _bind_ozaki(lib, old=False):
    n_ptr, n_int = (11, 12) if old else (13, 14)
    lib.ozaki_strip_f32.argtypes = ([ctypes.c_void_p] * n_ptr
                                    + [ctypes.c_int64] * n_int
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


def _bind_spmm(lib, old=False):
    lib.spmm_strip_f32.argtypes = ([ctypes.c_void_p] * (6 if old else 7)
                                   + [ctypes.c_int64] * 6 + [ctypes.c_void_p])
    lib.spmm_strip_f32.restype = ctypes.c_int


def _stream():
    import torch

    return torch.cuda.current_stream().cuda_stream


def _ozaki_old(lib, ops, kw):
    """A launch through the Ozaki kernel's interface before its redesign:
    no K-major scratch. Returns the four planes."""
    import torch

    from spgemm_tpu_torch.ops import ozaki_kernels as ok

    ntp, stack_rows, tm, tk, tn, n_blocks, pmax, _ = ok._geometry(
        ops[0], ops[1], ops[3], gm=kw["gm"], max_b=kw["max_b"],
        block_rows=kw["block_rows"], sa=kw["sa"], sb=kw["sb"],
        pmax=kw["pmax"])
    planes = [torch.empty(n_blocks * kw["max_cblock"], tm, tn,
                          device=ops[0].device) for _ in range(4)]
    err = lib.ozaki_strip_f32(
        *[t.data_ptr() for t in ops], *[p.data_ptr() for p in planes],
        kw["gm"], kw["block_rows"], kw["max_b"], kw["max_cblock"], n_blocks,
        tm, tk, tn, stack_rows, kw["sa"], kw["sb"], pmax, _stream())
    if err:
        raise RuntimeError(f"Ozaki kernel (old interface): CUDA error {err}")
    return tuple(planes)


def _spmm_old(lib, ops, kmin, *, gm, block_rows):
    """A launch through the SpMM kernel's interface before the narrow
    form's sector map: (a, xb, aptr, ak, kmin, y, ...)."""
    import torch

    a_dense, xb = ops[0], ops[1]
    n_rows = max(1, -(-gm // block_rows)) * block_rows
    y = torch.empty(n_rows, a_dense.shape[1], xb.shape[2],
                    device=a_dense.device)
    err = lib.spmm_strip_f32(
        a_dense.data_ptr(), xb.data_ptr(), ops[2].data_ptr(),
        ops[3].data_ptr(), None if kmin is None else kmin.data_ptr(),
        y.data_ptr(), gm, block_rows, n_rows, a_dense.shape[1],
        a_dense.shape[2], xb.shape[2], _stream())
    if err:
        raise RuntimeError(f"SpMM kernel (old interface): CUDA error {err}")
    return y


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


def _long_sums(libs, old_spmm: bool, names) -> None:
    """Prints each side's worst error on long sums of positive products,
    max |C - C64| / (1e-5 |C64| + 1e-6 max|C64|) against the f64 product
    of the f32-rounded operands (above 1 misses rtol 1e-5), for the strip
    and pair kernels on C = A (256 x 4096) times B (4096 x 256) at 30%
    density with uniform values (about 370 products over 512 mma steps per
    entry), and for SpMM's 128-column form on Y = A X with a uniform X at
    k = 128, resident, and 256, windowed (about 1,230 products per
    entry). `libs` maps (kernel, side) to a library; `old_spmm`: the base
    SpMM library is on the interface before the sector map; `names` the
    kernel sources to check."""
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
        if name not in names:
            continue
        for side in ("base", "new"):
            mod._lib = libs[name, side]
            got = pt.spgemm(at, bt, backend=backend, device="cuda").c
            print(f"{name} long positive sums: {side} worst error / "
                  f"(1e-5|C| + 1e-6 max|C|) = "
                  f"{worst(got.to_csr().to_dense(), ref)!r}")
    if "spmm_strip" not in names:
        return
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
            y = (_spmm_old(smk._lib, ops, form, gm=t.gm, block_rows=8)
                 if side == "base" and old_spmm else
                 smk.spmm_strip(*ops, form, gm=t.gm, block_rows=8))
            got = y.reshape(-1, k)[:256].double().cpu().numpy()
            print(f"spmm_strip k {k} long positive sums: {side} worst error"
                  f" / (1e-5|Y| + 1e-6 max|Y|) = {worst(got, ref)!r}")


SOURCES = ("ozaki_strip", "esc_scan", "strip_numeric", "pair_accumulate",
           "spmm_strip")


def main(base_dir: str, only=SOURCES) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from spgemm_tpu_torch.ops import kernels
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops import pair_kernels as pk
    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops import spmm_kernels as smk
    from spgemm_tpu_torch.utils.generators import cantlike, suite

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    jobs = {}
    old = {}
    for name, mod, bind in (
            ("ozaki_strip", ok, _bind_ozaki),
            ("esc_scan", sk, _bind_scan),
            ("strip_numeric", kernels, _bind_strip),
            ("pair_accumulate", pk, _bind_pair),
            ("spmm_strip", smk, _bind_spmm)):
        if name not in only:
            continue
        base_src = os.path.join(base_dir, name + ".cu")
        old[name] = _old_abi(name, base_src)
        base_bind = (lambda lib, b=bind: b(lib, old=True)) if old[name] \
            else bind
        jobs[name, "base"] = (base_src, f"lib{name}_base", mod.NVCC_FLAGS,
                              base_bind)
        jobs[name, "new"] = (mod.KERNEL_SRC, f"lib{name}_new",
                             mod.NVCC_FLAGS, bind)
    print(f"base sides on the interface before the Hopper redesign: "
          f"{[n for n, o in old.items() if o]}")
    libs = _build_all(jobs)
    sides = lambda name: {side: libs[name, side] for side in ("base", "new")}
    out = {}

    if {"ozaki_strip", "strip_numeric", "pair_accumulate"} & set(only):
        a0 = cantlike(62451, 64)
    if "ozaki_strip" in only:
        _ab_ozaki(a0, sides, old["ozaki_strip"], libs, out)
    if {"esc_scan", "spmm_strip"} & set(only):
        mats = suite(65536)
    if "esc_scan" in only:
        _ab_scans(mats, sides, out)
    if "strip_numeric" in only:
        _ab_strip(a0, sides, out)
    if "pair_accumulate" in only:
        _ab_pair(a0, sides, out)
    _long_sums(libs, old.get("spmm_strip", False), only)
    torch.cuda.empty_cache()
    if "spmm_strip" in only:
        _ab_spmm(mats["banded65536"], sides, old["spmm_strip"], libs, out)
    print(json.dumps(out))
    return 0


def _ab_ozaki(a0, sides, old_abi, libs, out):
    """The Ozaki kernel on the cant-like A^2 at 32x128, standard-normal
    values."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops.ozaki import build_ozaki_strip

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
    calls = {side: _swap(ok, lib, run)
             for side, lib in sides("ozaki_strip").items()}
    if old_abi:
        calls["base"] = lambda: _ozaki_old(libs["ozaki_strip", "base"], ops,
                                           kw)
    out["ozaki_strip"] = _ab(
        "ozaki_strip cant-like tm 32", calls,
        lambda: ok.ozaki_strip_numeric_plain(*ops, **kw))
    del ops, plan, run
    torch.cuda.empty_cache()


def _ab_scans(mats, sides, out):
    """The premul and mul scans on rmat65536's A^2, double-double on
    random65536's with standard-normal values."""
    import torch

    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops.esc import (build_esc_scan_plan,
                                          choose_group_rows, gather_planes,
                                          scan_dd_planes)

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


def _ab_strip(a0, sides, out):
    """The strip kernel on the cant-like A^2's main plan at 64x128 with
    integer values, then with standard-normal ones, then at tm 32, 16, 8."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import kernels
    from spgemm_tpu_torch.ops.gustavson import build_strip_args

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
    # the other compiled heights, integer values (their registers differ
    # the most between the revisions)
    for tm in (32, 16, 8):
        hargs = build_strip_args(csr_to_tiles(a0, tm, 128),
                                 csr_to_tiles(a0, 128, 128))
        hops = hargs.to_device("cuda")
        hkw = hargs.kernel_kwargs()
        hrun = lambda: kernels.strip_numeric(*hops, **hkw)
        out[f"strip_numeric_tm{tm}"] = _ab(
            f"strip_numeric cant-like tm {tm}",
            {side: _swap(kernels, lib, hrun)
             for side, lib in sides("strip_numeric").items()},
            lambda: kernels.strip_numeric_plain(*hops, **hkw))
        del hops, hargs, hrun
    torch.cuda.empty_cache()


def _ab_pair(a0, sides, out):
    """The pair kernel on the cant-like A^2's pair schedule at 64x128,
    integer values with the bfloat16 occupancy, then standard-normal
    values."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import pair_kernels as pk
    from spgemm_tpu_torch.ops.symbolic import build_pair_schedule

    at, bt = csr_to_tiles(a0, 64, 128), csr_to_tiles(a0, 128, 128)
    ag = a0.with_data(np.random.default_rng(0).standard_normal(a0.nnz))
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


def _ab_spmm(band, sides, old_abi, libs, out):
    """SpMM on the suite's banded65536 at 16x128 and 64x128: k 128
    (resident) and 256 (window, the 128-column form), with the suite's
    values and standard-normal X, then integer A and X (the one-product
    path, bit-equal); then SpMV (the narrow form) at 16x128."""
    import torch

    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import spmm as pspmm
    from spgemm_tpu_torch.ops import spmm_kernels as smk
    from spgemm_tpu_torch.utils.timing import profiler_device_ms

    block_rows = 64
    rng = np.random.default_rng(41)
    band_int = band.with_data(np.random.default_rng(42).integers(
        1, 10, band.nnz).astype(np.float64))
    for tm in (16, 64):
        t = csr_to_tiles(band, tm, 128)
        t_int = csr_to_tiles(band_int, tm, 128)
        stats = pspmm._spmm_block_stats(t, block_rows)
        for values, tiles in (("", t), (" integer", t_int)):
            for k, form in ((128, "resident"), (256, "window")):
                x = (rng.standard_normal((band.n, k)) if not values else
                     rng.integers(-4, 5, (band.n, k))).astype(np.float32)
                ops = pspmm._pack_spmm_operands(tiles, x, k, torch.float32,
                                                block_rows).to_device("cuda")
                km = (torch.from_numpy(pspmm._window_kmin(t, stats)).to(
                    "cuda") if form == "window" else None)
                kw = dict(gm=t.gm, block_rows=block_rows)
                run = lambda: smk.spmm_strip(*ops, km, **kw)
                calls = {side: _swap(smk, lib, run)
                         for side, lib in sides("spmm_strip").items()}
                if old_abi:
                    calls["base"] = lambda: _spmm_old(
                        libs["spmm_strip", "base"], ops, km, **kw)
                key = "" if tm == 16 else f"_tm{tm}"
                out[f"spmm_strip_k{k}{values.replace(' ', '_')}{key}"] = _ab(
                    f"spmm_strip banded65536 {tm}x128 k {k} {form}{values}",
                    calls, lambda: smk.spmm_strip_plain(*ops, km, **kw),
                    close=not values)
                del ops, run, calls
                torch.cuda.empty_cache()
    t = csr_to_tiles(band, 16, 128)
    # SpMV: k = 1 packed at width 8 on both sides (the narrow form; the new
    # side reads A by its sector map), then the new side at width 1, the
    # width spmv packs X at since the redesign
    x = rng.standard_normal((band.n, 1)).astype(np.float32)
    for width in (8, 1):
        packed = pspmm._pack_spmm_operands(t, x, width, torch.float32,
                                           block_rows)
        ops, smap = packed.to_device("cuda"), packed.sector_map_to("cuda")
        kw = dict(gm=t.gm, block_rows=block_rows)
        run = lambda: smk.spmm_strip(*ops, **kw, smap=smap)
        calls = {side: _swap(smk, lib, run)
                 for side, lib in sides("spmm_strip").items()}
        if old_abi:
            calls["base"] = lambda: _spmm_old(libs["spmm_strip", "base"],
                                              ops, None, **kw)
        if width == 1:
            calls = {"new": calls["new"]}
        exp = smk.spmm_strip_plain(*ops, **kw)
        for side, call in calls.items():
            ok_ = _agree(_tuple(call()), (exp,), True)
            print(f"spmm_strip spmv width {width}: {side} close={ok_}")
            if not ok_:
                raise SystemExit(f"spmv width {width}: the {side} kernel "
                                 f"differs from its plain version")
        times = {}
        for side in ORDER:
            if side in calls:
                times.setdefault(side, []).append(
                    profiler_device_ms(calls[side]))
        print(f"spmm_strip spmv banded65536 16x128 width {width} device ms "
              f"(torch.profiler): {times}")
        out[f"spmm_strip_spmv_w{width}_device"] = times
        del ops, smap, packed, exp


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base_dir", help="the other revision's csrc directory")
    ap.add_argument("--only", default=",".join(SOURCES),
                    help="comma-separated kernel sources to compare, of "
                         + ", ".join(SOURCES))
    opts = ap.parse_args()
    only = tuple(opts.only.split(","))
    if not set(only) <= set(SOURCES):
        ap.error(f"--only takes {SOURCES}")
    sys.exit(main(opts.base_dir, only))
