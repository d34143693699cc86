"""The six example applications (ports of `examples/*.py`), each
runnable as

    python -m spgemm_tpu_torch.examples.<name> [positional args] [--device cpu]

on CUDA unless `--device cpu` is given. Each keeps the JAX example's
positional arguments and built-in check, and exits 1 where that check
fails: triangle_counting, amg_galerkin, markov_clustering, pagerank,
power_method and serving_loop.
"""

from __future__ import annotations

import argparse


def parse_args(argv, doc: str, **positional: int) -> argparse.Namespace:
    """The examples' command line: optional integer positionals with the
    JAX example's defaults, then --device (default CUDA)."""
    p = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    for name, default in positional.items():
        p.add_argument(name, nargs="?", type=int, default=default)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the plain versions)")
    return p.parse_args(argv)
