"""spgemm_tpu_torch: the PyTorch and CUDA port of spgemm_tpu.

Tiled sparse C = A*B (C = A^2 and C = A*A^T) on one NVIDIA H100. The JAX
package `spgemm_tpu` stays beside it as the reference each part of the
port is tested against; this package imports torch and never JAX.

Layout mirrors the JAX package:
  * models/ — CSR and the tiled format (TileMat), NumPy host code.
  * ops/    — strip planner (gustavson.py), the hand-written CUDA strip
              kernel and its plain PyTorch version (kernels.py, source in
              csrc/strip_numeric.cu), the ESC scan route for unstructured
              patterns (esc.py) with its three CUDA scan kernels and their
              plain versions (scan_kernels.py, source in csrc/esc_scan.cu),
              the Gustavson slab route (gustavson.py, torch ops), the
              Ozaki route for f64 on structured patterns (ozaki.py: the
              slab engine as torch ops, and the fused strip route with
              its CUDA kernel and plain version in ozaki_kernels.py,
              source in csrc/ozaki_strip.cu), SpMM/SpMV (spmm.py) with its
              CUDA strip kernel and plain version (spmm_kernels.py, source
              in csrc/spmm_strip.cu), the pair backends' schedule
              (symbolic.py), torch ops (numeric.py) and CUDA pair kernel
              with its plain version (pair_kernels.py, source in
              csrc/pair_accumulate.cu), orchestrator (spgemm.py), resident
              executors (executor.py), scipy oracle (golden.py).
              The ESC route's digit mode (esc.py: EscPlan, a one-hot
              `bmm`) has no hand kernel, as the reference's is XLA.
  * parallel/ — multi-device execution over torch.distributed (dist.py):
              the six sharded formulations of the JAX package's
              parallel/dist.py (pairs, Gustavson slabs, strip kernel, ESC
              scan kernel, ring, Ozaki f64), make_mesh, init_multihost;
              one process per device, NCCL on CUDA, gloo on the CPU.
  * io/     — Matrix Market reader and writer, .npz checkpoints.
  * utils/  — native C++ host layer (g++-built `native/csr2tile.cpp`),
              generators, CUDA-event timing and the torch.profiler trace,
              the H100 roofline, CSV sinks.
  * entry.py, examples/ — the compile-check entry point, the
              multi-device dry run (dryrun_multichip) and the six example
              applications (`python -m spgemm_tpu_torch.examples.<name>`).

Public functions take `device`: None means CUDA and raises without a
card; "cpu" runs the plain PyTorch versions (the tests use it).
"""

from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import TileMat, csr_to_tiles, tiles_to_csr
from spgemm_tpu_torch.ops.esc import (EscPlan, ScanPlan, build_esc_plan,
                                      build_esc_scan_plan, esc_scan_dd,
                                      spgemm_esc)
from spgemm_tpu_torch.ops.ozaki import build_ozaki_plan, spgemm_ozaki
from spgemm_tpu_torch.ops.spmm import spmm, spmm_gather, spmv
from spgemm_tpu_torch.ops.spgemm import SpGEMMResult, spgemm, spgemm_csr
from spgemm_tpu_torch.ops.executor import (EscExecutor, OzakiExecutor,
                                           StripExecutor)
from spgemm_tpu_torch.io.mmio import read_mtx, write_mtx
from spgemm_tpu_torch.io import checkpoint

__version__ = "0.1.0"

__all__ = [
    "CSR",
    "TileMat",
    "csr_to_tiles",
    "tiles_to_csr",
    "spgemm",
    "spgemm_csr",
    "SpGEMMResult",
    "StripExecutor",
    "spgemm_esc",
    "spgemm_ozaki",
    "build_ozaki_plan",
    "OzakiExecutor",
    "spmm",
    "spmv",
    "spmm_gather",
    "build_esc_scan_plan",
    "ScanPlan",
    "esc_scan_dd",
    "build_esc_plan",
    "EscPlan",
    "EscExecutor",
    "read_mtx",
    "write_mtx",
    "checkpoint",
    "__version__",
]
