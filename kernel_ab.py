"""A/B timing of the Ozaki strip kernel and the three ESC scan kernels on
one CUDA card: this checkout's sources against another revision's.

    git archive <rev> spgemm_tpu_torch/csrc | tar -x -C _checkout/parent
    python3 kernel_ab.py _checkout/parent/spgemm_tpu_torch/csrc

Both revisions' `ozaki_strip.cu` and `esc_scan.cu` are built with the
port's nvcc flags (their C interfaces are the same) and driven through the
port's wrappers on the main plans of `chip_smoke.py`: the cant-like
62,451^2 A^2 with standard-normal values at 32x128 tiles (the Ozaki
kernel), the suite's rmat65536 A^2 (premul and mul) and random65536 with
standard-normal values (double-double). Each kernel is first checked
bit-equal (torch.equal) to its plain version, then timed with CUDA events
(median of 20 calls after 3 warm-up calls) in the order base, new, new,
base, base, new, so that both sides see the same card in turns. Prints the
card's name and power limit, each build's ptxas registers and spills,
every timing, and last one JSON line {"<kernel>": {"base": [...],
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
    for fn, (regs, st, ld) in sorted(
            kernels.ptxas_usage(info["ptxas"]).items()):
        print(f"ptxas {stem} {fn}: {regs} registers, {st} bytes spill "
              f"stores, {ld} bytes spill loads")
    return lib


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


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _ab(label, module, libs, call, plain):
    """Check both libraries' results against the plain version's, then
    time them in ORDER. Returns {"base": [...], "new": [...]}."""
    import torch

    from spgemm_tpu_torch.utils.timing import cuda_event_ms

    exp = _tuple(plain())
    for side, lib in libs.items():
        module._lib = lib
        got = _tuple(call())
        torch.cuda.synchronize()
        equal = all(torch.equal(g, e) for g, e in zip(got, exp))
        print(f"{label}: {side} bit_equal={equal}")
        if not equal:
            raise SystemExit(f"{label}: the {side} kernel differs from its "
                             f"plain version")
        del got
    del exp
    torch.cuda.empty_cache()
    times = {"base": [], "new": []}
    for side in ORDER:
        module._lib = libs[side]
        times[side].append(cuda_event_ms(call, warmup=3, iters=20))
    print(f"{label}: ms {times}")
    return times


def main(base_dir: str) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import ozaki_kernels as ok
    from spgemm_tpu_torch.ops import scan_kernels as sk
    from spgemm_tpu_torch.ops.esc import (build_esc_scan_plan,
                                          choose_group_rows, gather_planes,
                                          scan_dd_planes)
    from spgemm_tpu_torch.ops.ozaki import build_ozaki_strip
    from spgemm_tpu_torch.utils.generators import cantlike, suite

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    oz_libs = {side: _build(src, f"libozaki_strip_{side}", ok.NVCC_FLAGS,
                            _bind_ozaki)
               for side, src in (("base", os.path.join(base_dir,
                                                       "ozaki_strip.cu")),
                                 ("new", ok.KERNEL_SRC))}
    sc_libs = {side: _build(src, f"libesc_scan_{side}", sk.NVCC_FLAGS,
                            _bind_scan)
               for side, src in (("base", os.path.join(base_dir,
                                                       "esc_scan.cu")),
                                 ("new", sk.KERNEL_SRC))}
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
    out["ozaki_strip"] = _ab(
        "ozaki_strip cant-like tm 32", ok, oz_libs,
        lambda: ok.ozaki_strip_numeric(*ops, **kw),
        lambda: ok.ozaki_strip_numeric_plain(*ops, **kw))
    del ops, plan
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
            out[mode] = _ab(f"{mode} {name}", sk, sc_libs,
                            lambda: w(*planes, meta, **kw),
                            lambda: plain(*planes, meta, **kw))
            del planes
        del meta, p
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
    sys.exit(main(sys.argv[1]))
