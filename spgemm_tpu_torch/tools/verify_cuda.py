"""Hardware verification drive of the PyTorch/CUDA port (counterpart of
the JAX package's `tools/verify_tpu.py`): the public API end to end on
the card against an independent NumPy dense matmul (not the library's
own oracles). Run from the repository root on a machine with one card:

    python -m spgemm_tpu_torch.tools.verify_cuda

It prints one line per check and ends with `FAILS: N`; it exits 0 only
when N is 0, and 1 without a card. Keep it current as the API grows.

Checks: the five SpGEMM backends for A^2 and A*A^T on the repository's
36x36 banded fixture; a random 700^2 through the strip kernel and
through ESC; EscExecutor run, value refresh and mul mode; the
double-double scan exact on integers; a heavy row wider than one window
group; the error paths; f64 through ESC, through auto (f32-exact on
integers) and through the Ozaki kernel (S = 1, bit-exact, equal to the
slab engine) and on general values (S = 8x8); the rounding probe; SpMM
k = 64 and SpMV; a rectangular A*B; the six sharded formulations on a
one-rank process group; the device window combine on windows taller than
COMBINE_K rows.

Where the JAX drive checks something only a TPU has, the port checks its
meaning here (each noted at its check): "fp64 without x64 on a tiled
backend" becomes f64 on backend="pallas" raising ValueError (the pair
kernel is f32); the Mosaic TwoSum-folding probe becomes
csrc/twosum_probe.cu built with the DD and Ozaki kernels' nvcc flags (no
multiply fused into an add, TwoSum's error term kept) and built once
more with --fmad=true, where it must see the fusion;
the SPGEMM_OZAKI_KERNEL/SPGEMM_OZAKI_COMBINE A/B becomes the fused
kernel against the slab engine (ozaki_core) on the same tiles. The
meta16/meta32 identity is not checked: the port always runs the int16
meta plane (SPGEMM_META16 is not carried).
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures", "banded_36x36.mtx")
PROBE_SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "twosum_probe.cu")


class Drive:
    """Counts failed checks; each check prints one line."""

    def __init__(self) -> None:
        self.fails = 0

    def check(self, ok, line: str) -> bool:
        ok = bool(ok)
        print(f"{line} ok={ok}", flush=True)
        self.fails += not ok
        return ok

    def raises(self, exc, fn, line: str) -> None:
        try:
            fn()
        except exc as e:
            print(f"{line} rejected: {e}", flush=True)
            return
        print(f"ERROR: {line} accepted", flush=True)
        self.fails += 1


def rounding_probe_launcher(flags: list[str]):
    """Builds csrc/twosum_probe.cu with nvcc `flags`; returns
    launch(x, twosum_err, contract_err), which runs the probe on the
    float32 CUDA tensor x into the two outputs (x's shape) on the current
    stream."""
    import torch

    from spgemm_tpu_torch.ops.kernels import build_cuda_library

    lib, _ = build_cuda_library(PROBE_SRC, "libtwosum_probe", flags)
    lib.twosum_probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                         ctypes.c_void_p]
    lib.twosum_probe.restype = ctypes.c_int

    def launch(x, ts, ce):
        rc = lib.twosum_probe(x.data_ptr(), ts.data_ptr(), ce.data_ptr(),
                              x.numel(),
                              torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"twosum_probe launch failed: CUDA error {rc}")
    return launch


def rounding_probe(flags: list[str], n: int = 8 * 128):
    """Builds csrc/twosum_probe.cu with nvcc `flags` and runs it on x = 1.
    Returns (twosum_err, contract_err) as NumPy arrays: 2^-30 and 0 each
    where the multiply and the adds round on their own, contract_err
    2^-24 where nvcc fused b*b - p into an FMA. Needs a card."""
    import torch

    x = torch.ones(n, dtype=torch.float32, device="cuda")
    ts, ce = torch.empty_like(x), torch.empty_like(x)
    rounding_probe_launcher(flags)(x, ts, ce)
    return ts.cpu().numpy(), ce.cpu().numpy()


def run() -> int:
    """Every check on the card; returns the number that failed."""
    import torch
    import torch.distributed as tdist

    from spgemm_tpu_torch.io.mmio import read_mtx
    from spgemm_tpu_torch.models.csr import CSR
    from spgemm_tpu_torch.models.tile import csr_to_tiles, tiles_to_csr
    from spgemm_tpu_torch.ops.esc import (COMBINE_K, build_esc_scan_plan,
                                          esc_scan_dd,
                                          esc_scan_numeric_combined,
                                          esc_scan_trim_combined)
    from spgemm_tpu_torch.ops.executor import EscExecutor
    from spgemm_tpu_torch.ops import ozaki_kernels, scan_kernels
    from spgemm_tpu_torch.ops.ozaki import (build_ozaki_plan, ozaki_compact,
                                            ozaki_numeric)
    from spgemm_tpu_torch.ops.spgemm import spgemm, spgemm_csr
    from spgemm_tpu_torch.ops.spmm import spmm, spmv
    from spgemm_tpu_torch.parallel import dist as pdist

    dev = torch.device("cuda")
    f64 = torch.float64
    v = Drive()
    close = lambda got, ref, **kw: np.allclose(got, ref, **kw)

    a, _ = read_mtx(FIXTURE)
    ad = a.to_dense()
    ref_sq, ref_aat = ad @ ad, ad @ ad.T
    for backend in ("strip", "gustavson", "dense", "esc", "xla"):
        c, _ = spgemm_csr(a, backend=backend, device=dev)
        v.check(close(c.to_dense(), ref_sq, rtol=1e-5, atol=1e-8),
                f"A^2  backend={backend:10s} nnzC={c.nnz}")
        c2, _ = spgemm_csr(a, aat=True, backend=backend, device=dev)
        v.check(close(c2.to_dense(), ref_aat, rtol=1e-5, atol=1e-8),
                f"AAT  backend={backend:10s} nnzC={c2.nnz}")

    # a bigger random problem on the strip kernel (the bench kernel)
    rng = np.random.default_rng(0)
    m, nnz = 700, 9000
    ar = CSR.from_coo(rng.integers(0, m, nnz), rng.integers(0, m, nnz),
                      rng.normal(size=nnz), (m, m))
    ard = ar.to_dense()
    c3, r3 = spgemm_csr(ar, tm=16, tn=128, backend="strip", device=dev)
    v.check(close(c3.to_dense(), ard @ ard, rtol=1e-4, atol=1e-6),
            f"random 700x700 strip backend={r3.stats['backend']}")
    c3e, _ = spgemm_csr(ar, backend="esc", device=dev)
    v.check(close(c3e.to_dense(), ard @ ard, rtol=1e-4, atol=1e-6),
            "random 700x700 esc")

    # EscExecutor: resident run, value refresh, in-kernel multiply
    pex = build_esc_scan_plan(ar, ar, keep_sources=True)
    for mode in ("premul", "mul"):
        exq = EscExecutor(pex, mode=mode, device=dev)
        okx = close(exq.run_csr().to_dense(), ard @ ard, rtol=1e-4,
                    atol=1e-6)
        new_vals = rng.standard_normal(ar.nnz)
        exq.update_values(new_vals, ar.data)
        ar2d = ar.with_data(new_vals).to_dense()
        okx2 = close(exq.run_csr().to_dense(), ar2d @ ard, rtol=1e-4,
                     atol=1e-6)
        v.check(okx and okx2, f"esc executor mode={mode} run ok={okx} "
                              f"refresh ok={okx2}")

    # the double-double scan: exact on integer values
    ai = CSR.from_coo(rng.integers(0, 700, 9000), rng.integers(0, 700, 9000),
                      rng.integers(1, 10, 9000).astype(np.float64),
                      (700, 700))
    cdd = esc_scan_dd(build_esc_scan_plan(ai, ai), ai.data, ai.data,
                      device=dev)
    v.check(np.array_equal(cdd.to_dense(), ai.to_dense() @ ai.to_dense()),
            "f64 double-double scan exact")

    # a heavy row wider than one 2048-slot group
    hr = np.concatenate([np.zeros(2500, np.int64), rng.integers(1, 600, 4000)])
    hc = np.concatenate([rng.choice(3000, 2500, replace=False),
                         rng.integers(0, 3000, 4000)])
    heavy = CSR.from_coo(hr, hc, rng.normal(size=hr.size), (600, 3000))
    tall = CSR.from_coo(rng.integers(0, 3000, 9000),
                        rng.integers(0, 3000, 9000),
                        rng.normal(size=9000), (3000, 3000))
    ch, resh = spgemm_csr(heavy, b=tall, backend="esc", device=dev)
    v.check(close(ch.to_dense(), heavy.to_dense() @ tall.to_dense(),
                  rtol=1e-4, atol=1e-6),
            f"heavy-row 600x3000 esc backend={resh.stats['backend']}")

    # error paths
    v.raises(ValueError, lambda: spgemm_csr(
        CSR.from_coo([0], [1], [1.0], (2, 3)), device=dev),
        "non-square A^2")
    v.raises(ValueError, lambda: spgemm_csr(ar, b=ar, aat=True, device=dev),
             "b+aat")
    # the JAX drive's "fp64 without x64 on a tiled backend": the port has
    # no x64 switch; its f32-only tiled kernel is the pair kernel
    v.raises(ValueError, lambda: spgemm_csr(ar, compute_dtype=f64,
                                            backend="pallas", device=dev),
             "fp64 on backend=pallas (f32-only pair kernel)")
    cdd0, _ = spgemm_csr(ar, compute_dtype=f64, backend="esc", device=dev)
    v.check(close(cdd0.to_dense(), ard @ ard, rtol=1e-12, atol=1e-12),
            "fp64 via esc double-double")

    # f64 on a structured matrix: auto takes the f32-exact route on
    # integers (bit-exact by the 2^24 bound); the explicit ozaki backend
    # runs the fused kernel at S = 1 (one int8 product per slab pair)
    sr = np.repeat(np.arange(512), 65)
    sc = sr + np.tile(np.arange(-32, 33), 512)
    sk = (sc >= 0) & (sc < 512)
    astr = CSR.from_coo(sr[sk], sc[sk],
                        ((sr[sk] * 3 + sc[sk]) % 9 + 1).astype(np.float64),
                        (512, 512))
    exact = astr.to_dense() @ astr.to_dense()
    cda, rda = spgemm_csr(astr, compute_dtype=f64, backend="auto",
                          device=dev)
    v.check("f64-exact-int" in str(rda.stats["backend"])
            and np.array_equal(cda.to_dense(), exact),
            f"fp64 auto->f32-exact structured (backend="
            f"{rda.stats['backend']})")
    cdo, rdo = spgemm_csr(astr, compute_dtype=f64, backend="ozaki",
                          device=dev)
    v.check(str(rdo.stats["backend"]).startswith("ozaki-strip")
            and np.array_equal(cdo.to_dense(), exact),
            f"fp64 explicit ozaki (S=1 int8 products) (backend="
            f"{rdo.stats['backend']})")
    # the JAX drive's SPGEMM_OZAKI_KERNEL=xla A/B: the slab engine
    # (ozaki_core, torch ops) on the same 16x128 tiles
    at1, bt1 = csr_to_tiles(astr, 16, 128), csr_to_tiles(astr, 128, 128)
    oplan = build_ozaki_plan(at1, bt1)
    out, _ = ozaki_numeric(oplan, device=dev)
    csl = ozaki_compact(oplan, *out, astr.shape)
    v.check(np.array_equal(csl.to_csr().to_dense(), cdo.to_dense()),
            f"ozaki fused strip kernel == slab engine (S={oplan.sa}x"
            f"{oplan.sb}, exact)")
    # the JAX drive's Mosaic probe becomes nvcc's: built with the DD and
    # Ozaki kernels' flags, no multiply is fused into an add and TwoSum's
    # error term survives; built with --fmad=true, the probe must see the
    # fusion (else it could not fail)
    flags = ozaki_kernels.NVCC_FLAGS
    v.check(scan_kernels.NVCC_FLAGS == flags,
            "DD scan and Ozaki kernels share nvcc flags")
    ts, ce = rounding_probe(flags)
    v.check(np.all(ts == np.float32(2.0 ** -30)) and np.all(ce == 0),
            f"nvcc {' '.join(f for f in flags if 'fmad' in f)}: TwoSum err "
            f"== 2^-30 (got {np.unique(ts)[:4]}), b*b - p == 0 (got "
            f"{np.unique(ce)[:4]})")
    _, ce_fused = rounding_probe(
        [f if f != "--fmad=false" else "--fmad=true" for f in flags])
    v.check(np.all(ce_fused == np.float32(2.0 ** -24)),
            f"nvcc --fmad=true: the probe sees the FMA (b*b - p == 2^-24, "
            f"got {np.unique(ce_fused)[:4]})")
    # general significands through ozaki (S = 8x8)
    astg = astr.with_data(np.random.default_rng(42).standard_normal(
        astr.nnz))
    cdg, rdg = spgemm_csr(astg, compute_dtype=f64, backend="auto",
                          device=dev)
    v.check(str(rdg.stats["backend"]).startswith("ozaki")
            and close(cdg.to_dense(), astg.to_dense() @ astg.to_dense(),
                      rtol=1e-12, atol=1e-12),
            f"fp64 ozaki general values (backend={rdg.stats['backend']})")

    # SpMM (k = 64) and SpMV on the strip kernel
    t = csr_to_tiles(ar, 16, 128)
    xk = rng.standard_normal((ar.n, 64)).astype(np.float32)
    y = spmm(t, xk, device=dev).cpu().numpy()
    v.check(close(y, ard.astype(np.float32) @ xk, rtol=1e-4, atol=1e-5),
            "spmm strip 700x700 k=64")
    yv = spmv(t, xk[:, 0], device=dev).cpu().numpy()
    v.check(close(yv, ard.astype(np.float32) @ xk[:, 0], rtol=1e-4,
                  atol=1e-5), "spmv")

    # rectangular A @ B through the strip kernel
    br = CSR.from_coo(rng.integers(0, 300, 5000), rng.integers(0, 900, 5000),
                      rng.normal(size=5000), (300, 900))
    arect = CSR.from_coo(rng.integers(0, 700, 8000),
                         rng.integers(0, 300, 8000),
                         rng.normal(size=8000), (700, 300))
    res = spgemm(csr_to_tiles(arect, 16, 128), csr_to_tiles(br, 128, 128),
                 backend="strip", device=dev)
    v.check(close(tiles_to_csr(res.c).to_dense(),
                  arect.to_dense() @ br.to_dense(), rtol=1e-4, atol=1e-6),
            f"rect 700x300 @ 300x900 strip backend={res.stats['backend']}")

    # the six sharded formulations on a one-rank NCCL process group
    backend = "nccl"
    pdist.init_multihost(f"127.0.0.1:{pdist._free_port()}", num_processes=1,
                         process_id=0, backend=backend)
    try:
        mesh = pdist.make_mesh(1, device=dev)
        tsm = csr_to_tiles(ar, 16, 16)
        for fn, tag in ((pdist.spgemm_sharded, "sharded"),
                        (pdist.spgemm_sharded_ring, "ring"),
                        (pdist.spgemm_sharded_pairs, "pairs")):
            cs = fn(tsm, tsm, mesh)
            v.check(close(tiles_to_csr(cs).to_dense(), ard @ ard, rtol=1e-4,
                          atol=1e-6), f"dist {tag} ({backend}, 1 rank)")
        cs = pdist.spgemm_sharded_strip(t, csr_to_tiles(ar, 128, 128), mesh)
        v.check(close(tiles_to_csr(cs).to_dense(), ard @ ard, rtol=1e-4,
                      atol=1e-6), f"dist strip ({backend}, 1 rank)")
        ce = pdist.spgemm_sharded_esc(ar, ar, mesh)
        v.check(close(ce.to_dense(), ard @ ard, rtol=1e-4, atol=1e-6),
                f"dist esc ({backend}, 1 rank)")
        ti = csr_to_tiles(ai, 16, 128)
        co = pdist.spgemm_sharded_ozaki(ti, csr_to_tiles(ai, 128, 128), mesh)
        v.check(np.array_equal(tiles_to_csr(co).to_dense(),
                               ai.to_dense() @ ai.to_dense()),
                f"dist ozaki f64 exact ({backend}, 1 rank)")
    finally:
        tdist.destroy_process_group()

    # the device window combine's tail path (windows taller than COMBINE_K)
    bn = 384
    boffs = np.arange(-40, 41)
    brr = np.repeat(np.arange(bn), boffs.size)
    bc = brr + np.tile(boffs, bn)
    bkeep = (bc >= 0) & (bc < bn)
    bval = ((brr[bkeep] * 7 + bc[bkeep] * 13) % 9 + 1).astype(np.float64)
    bdup = CSR.from_coo(brr[bkeep], bc[bkeep], bval, (bn, bn))
    pdup = build_esc_scan_plan(bdup, bdup)
    tall_windows = bool((np.diff(pdup.win_rowptr) > COMBINE_K).any())
    rr, tt = esc_scan_numeric_combined(pdup, device=dev)
    cdup = esc_scan_trim_combined(pdup, rr, tt)
    v.check(tall_windows and np.array_equal(
        cdup.to_dense(), bdup.to_dense() @ bdup.to_dense()),
        f"device combine (tall windows: {tall_windows}) exact")
    return v.fails


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("verify_cuda: no CUDA device", file=sys.stderr)
        return 1
    from spgemm_tpu_torch.utils.timing import card_line

    print(f"devices: {card_line()} count={torch.cuda.device_count()}",
          flush=True)
    fails = run()
    print("FAILS:", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
