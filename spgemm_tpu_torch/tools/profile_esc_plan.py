"""Profile the ESC scan-plan build stage by stage (host only, no card):
the port's counterpart of the JAX package's `tools/profile_esc_plan.py`.

The ESC route's host symbolic is the largest wall of the port (PERF.md
§5). This times the native `esc_scan_build` (utils/native.py:
esc_scan_symbolic_native) cold and warm, splits the warm build into its
stages (walk, extract, layout, scatter, flush: TSC tick fractions from
the build's stats[2:7], `utils/native.py:last_scan_build_stages`, scaled
onto wall time), and times build_esc_scan_plan.

Usage (from the repository root):
  python -m spgemm_tpu_torch.tools.profile_esc_plan \
      [rmat65536|random65536|...] [--sources]

The matrix is drawn from default_rng(1234), as the JAX tool draws it.
rmat65536's plan takes about 10 GB of host planes: run that size on a
machine with the memory for it.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from spgemm_tpu_torch.utils.generators import (banded, block_diag, power_law,
                                               random_uniform, rmat)

GENERATORS = dict(banded=banded, blockdiag=block_diag, random=random_uniform,
                  powerlaw=power_law, rmat=rmat)


def parse_name(name: str) -> tuple[str, int]:
    """"rmat65536" -> ("rmat", 65536)."""
    n = int("".join(ch for ch in name if ch.isdigit()))
    return name[: -len(str(n))], n


def stage_split(stages: dict | None, wall_s: float) -> dict:
    """Each stage's share of the build's TSC ticks, scaled onto wall
    seconds: {stage: (fraction, seconds)}; empty without ticks."""
    if not stages or not sum(stages.values()):
        return {}
    tot = sum(stages.values())
    return {k: (v / tot, wall_s * v / tot) for k, v in stages.items()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names = [a for a in argv if not a.startswith("--")]
    name = names[0] if names else "rmat65536"
    keep_sources = "--sources" in argv
    kind, n = parse_name(name)
    a = GENERATORS[kind](np.random.default_rng(1234), n)
    print(f"{name}: m={a.m} nnzA={a.nnz} keep_sources={keep_sources}")

    from spgemm_tpu_torch.utils import native as nv

    t0 = time.perf_counter()
    res = nv.esc_scan_symbolic_native(a, a, keep_sources=keep_sources)
    t1 = time.perf_counter()
    if res is None:
        raise RuntimeError("native library unavailable (g++ build failed)")
    c_indptr, _, flops, qv, *_ = res
    print(f"native symbolic total:  {1e3 * (t1 - t0):9.1f} ms  "
          f"F={flops}  nnzC={int(c_indptr[-1])}  R={qv.shape[0]}  "
          f"({flops / max(t1 - t0, 1e-9) / 1e6:.1f} M prod/s)")

    # second build, steady state; release the first build's planes first
    del res, c_indptr, qv
    t2 = time.perf_counter()
    res2 = nv.esc_scan_symbolic_native(a, a, keep_sources=keep_sources)
    t3 = time.perf_counter()
    del res2
    print(f"rebuild (warm):         {1e3 * (t3 - t2):9.1f} ms  "
          f"({flops / max(t3 - t2, 1e-9) / 1e6:.1f} M prod/s)")

    split = stage_split(nv.last_scan_build_stages, t3 - t2)
    if split:
        print("stage split:            "
              + "  ".join(f"{k}={100 * f:.0f}% (~{s:.2f}s)"
                          for k, (f, s) in split.items()))

    from spgemm_tpu_torch.ops.esc import build_esc_scan_plan

    t4 = time.perf_counter()
    plan = build_esc_scan_plan(a, a, keep_sources=keep_sources)
    t5 = time.perf_counter()
    print(f"build_esc_scan_plan:    {1e3 * (t5 - t4):9.1f} ms  "
          f"passes={plan.passes}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
