"""Profile the ESC plan build's A^2 against its A*A^T (host only, no
card): the port's counterpart of the JAX package's
`tools/profile_aat_plan.py`. Prints, for B = A and B = A^T, the
structural statistics that differ between them (per-C-row product
counts, distinct-destination widths, the duplicate ratio, B-row nnz
spread) and the best of `reps` native builds with its stage split
(`utils/native.py:last_scan_build_stages`, scaled onto wall time), so a
cost can be pinned to a stage and a property.

Usage (from the repository root):
  python -m spgemm_tpu_torch.tools.profile_aat_plan [rmat8192] [reps]

The matrix is drawn from default_rng(7), run_suite's seed.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from spgemm_tpu_torch.tools.profile_esc_plan import (GENERATORS, parse_name,
                                                     stage_split)


def stats(a, b, label: str) -> None:
    import scipy.sparse as sp

    ra = np.diff(a.indptr)
    rb = np.diff(b.indptr)
    f_row = np.zeros(a.m, np.int64)
    np.add.at(f_row, np.repeat(np.arange(a.m), ra), rb[a.indices])
    sa = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape)
    sb = sp.csr_matrix((b.data, b.indices, b.indptr), shape=b.shape)
    c = (sa @ sb).tocsr()
    width = np.diff(c.indptr)
    f = int(f_row.sum())
    print(f"{label}: F={f} nnzC={c.nnz} dup={f / max(c.nnz, 1):.2f} "
          f"max_row_F={f_row.max()} max_row_width={width.max()} "
          f"Brow_nnz max={rb.max()} p99={np.percentile(rb, 99):.0f}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "rmat8192"
    reps = int(argv[1]) if len(argv) > 1 else 3
    kind, n = parse_name(name)
    a = GENERATORS[kind](np.random.default_rng(7), n)

    from spgemm_tpu_torch.utils import native as nv

    for label, b in (("A2 ", a), ("AAT", a.transpose())):
        stats(a, b, label)
        best, stages = None, None
        for _ in range(reps):
            t0 = time.perf_counter()
            res = nv.esc_scan_symbolic_native(a, b, keep_sources=False)
            dt = time.perf_counter() - t0
            if res is None:
                raise RuntimeError("native library unavailable (g++ build "
                                   "failed)")
            del res
            if best is None or dt < best:
                best, stages = dt, dict(nv.last_scan_build_stages)
        print(f"{label}: build best {1e3 * best:8.1f} ms   "
              + "  ".join(f"{k}={1e3 * s:.0f}ms"
                          for k, (_, s) in stage_split(stages, best).items()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
