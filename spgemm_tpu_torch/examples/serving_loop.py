"""Pattern-static serving loop: build once, run many (port of
`examples/serving_loop.py`).

A sparsity pattern is fixed (a mesh, a graph, a circuit); values change
every tick. The symbolic work (tiling, strip planning, scan-plan build)
happens once; each tick is then

    update_values(...)   # host gather(+multiply) of the new values
    run()                # one device step on resident planes

Through the three executors, so the API is uniform:
  structured pattern  -> StripExecutor (the strip kernel, f32)
  unstructured        -> EscExecutor   (the scan kernel)
  exact f64           -> OzakiExecutor (the Ozaki slab engine)
Every tick is checked against scipy and prints OK or MISMATCH.

    python -m spgemm_tpu_torch.examples.serving_loop [n] [ticks] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from spgemm_tpu_torch.examples import parse_args
from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import csr_to_tiles
from spgemm_tpu_torch.ops import golden
from spgemm_tpu_torch.ops.esc import build_esc_scan_plan
from spgemm_tpu_torch.ops.executor import (EscExecutor, OzakiExecutor,
                                           StripExecutor)
from spgemm_tpu_torch.ops.ozaki import build_ozaki_plan, ozaki_compact


def banded(n: int, band: int, seed: int = 0) -> CSR:
    rng = np.random.default_rng(seed)
    offs = np.arange(-band, band + 1)
    r = np.repeat(np.arange(n), offs.size)
    c = r + np.tile(offs, n)
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    return CSR.from_coo(r, c, rng.standard_normal(r.size), (n, n))


def unstructured(n: int, deg: int, seed: int = 1) -> CSR:
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n, n * deg)
    c = rng.integers(0, n, n * deg)
    return CSR.from_coo(r, c, rng.standard_normal(r.size), (n, n))


def _check(got: CSR, ref: CSR, *, rtol: float, atol: float) -> bool:
    got = golden.drop_explicit_zeros(got)
    return got.pattern_equal(ref) and np.allclose(got.data, ref.data,
                                                  rtol=rtol, atol=atol)


def serve(n: int, ticks: int, device=None) -> bool:
    """Runs the three engines for `ticks` ticks each; True when every
    tick matched scipy."""
    rng = np.random.default_rng(42)
    all_ok = True

    # --- structured: StripExecutor -------------------------------------
    a = banded(n, 16)
    at = csr_to_tiles(a, 16, 128)
    bt = csr_to_tiles(a, 128, 128)  # B's inner blocking must match tn
    t0 = time.perf_counter()
    ex = StripExecutor(at, bt, device=device)
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[strip] plan built once: {build_ms:.1f} ms "
          f"(pairs={ex.args.num_pairs})")
    # A's values change every tick, B is the fixed operator (B's packed
    # slabs stay resident; only A's value plane is uploaded again)
    for tick in range(ticks):
        vals = rng.standard_normal(a.nnz)
        a_new = CSR(a.indptr, a.indices, vals, a.shape)
        t0 = time.perf_counter()
        ex.update_values(csr_to_tiles(a_new, 16, 128))
        c_tiles = ex.run_compact()
        tick_ms = (time.perf_counter() - t0) * 1e3
        ok = _check(c_tiles.to_csr(), golden.spgemm_scipy(a_new, a),
                    rtol=1e-4, atol=1e-6)
        all_ok &= ok
        print(f"[strip] tick {tick}: {tick_ms:.1f} ms "
              f"nnzC={c_tiles.nnz} {'OK' if ok else 'MISMATCH'}")

    # --- unstructured: EscExecutor -------------------------------------
    u = unstructured(n, 8)
    t0 = time.perf_counter()
    plan = build_esc_scan_plan(u, u, keep_sources=True)
    ex2 = EscExecutor(plan, device=device)
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[esc]   plan built once: {build_ms:.1f} ms "
          f"(F={plan.num_products})")
    for tick in range(ticks):
        vals = rng.standard_normal(u.nnz)
        t0 = time.perf_counter()
        ex2.update_values(vals, vals)
        c = ex2.run_csr()
        tick_ms = (time.perf_counter() - t0) * 1e3
        un = CSR(u.indptr, u.indices, vals, u.shape)
        ok = _check(c, golden.spgemm_scipy(un, un), rtol=1e-4, atol=1e-6)
        all_ok &= ok
        print(f"[esc]   tick {tick}: {tick_ms:.1f} ms "
              f"nnzC={c.nnz} {'OK' if ok else 'MISMATCH'}")

    # --- exact f64: OzakiExecutor --------------------------------------
    af = banded(n, 8, seed=7)
    atf = csr_to_tiles(af, 16, 128)
    btf = csr_to_tiles(af, 128, 128)
    t0 = time.perf_counter()
    oplan = build_ozaki_plan(atf, btf)
    ex3 = OzakiExecutor(oplan, atf, btf, device=device)
    build_ms = (time.perf_counter() - t0) * 1e3
    print(f"[ozaki] plan built once: {build_ms:.1f} ms "
          f"(S={oplan.sa}x{oplan.sb})")
    for tick in range(ticks):
        vals = rng.standard_normal(af.nnz)
        a_new = CSR(af.indptr, af.indices, vals, af.shape)
        t0 = time.perf_counter()
        ex3.update_values(csr_to_tiles(a_new, 16, 128),
                          csr_to_tiles(a_new, 128, 128))
        out = ex3.run()
        c_tiles = ozaki_compact(oplan, *out, af.shape)
        tick_ms = (time.perf_counter() - t0) * 1e3
        ref = golden.spgemm_scipy(a_new, a_new)
        # f64-eps-class relative to the result scale (tiny entries carry
        # the engine's blocked-accuracy bound)
        scale = np.abs(ref.data).max() if ref.nnz else 1.0
        ok = _check(c_tiles.to_csr(), ref, rtol=1e-9, atol=1e-13 * scale)
        all_ok &= ok
        print(f"[ozaki] tick {tick}: {tick_ms:.1f} ms "
              f"nnzC={c_tiles.nnz} {'OK' if ok else 'MISMATCH'} (f64)")
    return all_ok


def main(argv=None) -> int:
    args = parse_args(argv, __doc__, n=2048, ticks=3)
    return 0 if serve(args.n, args.ticks, device=args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
