"""Runs one cell of BENCHMARK.json once on one card and prints one JSON
line last on standard output.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (BENCHMARK.json beside the perfbench folder).
Without as many CUDA cards as the cell asks for it exits 1 and prints no
result: the benchmark never falls back to the CPU. It also exits 1 if JAX
or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# glibc's mallopt parameters
M_TRIM_THRESHOLD, M_TOP_PAD, M_MMAP_MAX = -1, -2, -4


def keep_freed_memory() -> None:
    """Serve every block from the heap and keep what is freed there.

    By default glibc maps each block of 128 KiB or more afresh and unmaps
    it when freed, so every call of the program faults its multi-GB host
    arrays in again. On a sandboxed H100 host that kernel time was about
    half of an A^2 call and the largest part of its spread from run to
    run; kept on the heap, the memory is faulted in once, in set-up
    (PERF.md, section 2)."""
    libc = ctypes.CDLL(None)
    libc.mallopt(M_MMAP_MAX, 0)
    libc.mallopt(M_TRIM_THRESHOLD, 2**31 - 1)
    libc.mallopt(M_TOP_PAD, 256 << 20)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    keep_freed_memory()

    # the program's own device_trace would nest a second profiler
    os.environ.pop("SPGEMM_TPU_TRACE", None)
    import torch

    from perfbench import harness

    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        harness.log(f"unknown workload {args.workload!r}; cells: "
                    f"{', '.join(cells)}")
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    result, lines = harness.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace),
        "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"JAX or the JAX package was loaded: {', '.join(bad)}")
        return 1
    harness.log(f"# {args.workload} seed {args.seed} on {harness.card_line()}: "
                f"{json.dumps(result['metrics'])}")
    for line in lines:
        harness.log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
