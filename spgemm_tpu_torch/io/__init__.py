"""Matrix I/O (Matrix Market) and checkpoints."""

from spgemm_tpu_torch.io.mmio import read_mtx, write_mtx

__all__ = ["read_mtx", "write_mtx"]
