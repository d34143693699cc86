"""Speed-of-light accounting (port of `spgemm_tpu/utils/roofline.py`),
with the H100's peaks as the default chip.

A call's bound is the larger of the bytes it must move (each input read
once, each output written once) over the memory rate and its operations
over the peak rate for their operand type. For the tile-pair numeric
step (`numeric_step_roofline`):

  useful FLOPs      = 2 * nnzCub                  (the reference's GFLOPS base)
  executed FLOPs    = 2 * num_pairs * tm * tk * tn  (x2 with the occupancy
                      product fused in)
  bytes (min)       = pair-streamed A+B tiles + C tiles written once
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ChipSpec:
    name: str
    peak_flops_f32: float   # FLOP/s
    peak_hbm_bw: float      # bytes/s
    # dense operations/s by operand type ("tf32", "bf16", "int8", "f32")
    peak_ops: dict[str, float] = dataclasses.field(default_factory=dict)

    @staticmethod
    def h100() -> "ChipSpec":
        """H100 SXM, NVIDIA's data sheet: 3.35 TB/s HBM3; dense tensor
        cores 495 TFLOP/s TF32, 989 bf16, 1,979 TOP/s int8; 67 TFLOP/s
        FP32 outside them. Rates assume the 700 W power limit."""
        return ChipSpec("h100-sxm", 67e12, 3.35e12,
                        {"tf32": 495e12, "bf16": 989e12, "int8": 1979e12,
                         "f32": 67e12})

    def bound(self, nbytes: float, ops=()) -> tuple[float, float, float, str]:
        """(bytes_ms, ops_ms, bound_ms, bound_by) for a call that moves
        `nbytes` and does `ops` [(count, type)] operations."""
        bytes_ms = nbytes / self.peak_hbm_bw * 1e3
        ops_ms = sum(n / self.peak_ops[kind] for n, kind in ops) * 1e3
        by = "bytes" if bytes_ms >= ops_ms else "operations"
        return bytes_ms, ops_ms, max(bytes_ms, ops_ms), by


@dataclasses.dataclass
class RooflineReport:
    executed_flops: float
    useful_flops: float
    bytes_moved: float
    sol_time_ms: float        # speed-of-light
    attained_ms: float | None
    efficiency: float | None  # sol / attained

    def summary(self) -> str:
        s = (
            f"executed {self.executed_flops/1e9:.2f} GFLOP "
            f"(useful {self.useful_flops/1e9:.2f}), "
            f"{self.bytes_moved/1e6:.1f} MB, SoL {self.sol_time_ms:.3f} ms"
        )
        if self.attained_ms is not None:
            s += (
                f", attained {self.attained_ms:.3f} ms "
                f"({100*(self.efficiency or 0):.1f}% of SoL)"
            )
        return s


def numeric_step_roofline(
    num_pairs: int,
    tm: int,
    tk: int,
    tn: int,
    nnz_cub: int,
    nt_c: int,
    attained_ms: float | None = None,
    chip: ChipSpec | None = None,
    bytes_per_elem: int = 4,
    with_occupancy_pass: bool = True,
) -> RooflineReport:
    chip = chip or ChipSpec.h100()
    mults = num_pairs * tm * tk * tn
    executed = 2.0 * mults * (2 if with_occupancy_pass else 1)
    useful = 2.0 * nnz_cub
    # minimum traffic: every pair streams one A and one B tile (x2 with
    # the occupancy plane), C written + read once per accumulation
    a_b_bytes = num_pairs * (tm * tk + tk * tn) * bytes_per_elem
    if with_occupancy_pass:
        a_b_bytes *= 2
    c_bytes = 2 * nt_c * tm * tn * bytes_per_elem * (
        2 if with_occupancy_pass else 1)
    total_bytes = a_b_bytes + c_bytes
    sol_s = max(executed / chip.peak_flops_f32, total_bytes / chip.peak_hbm_bw)
    eff = None
    if attained_ms is not None and attained_ms > 0:
        eff = (sol_s * 1e3) / attained_ms
    return RooflineReport(
        executed_flops=executed,
        useful_flops=useful,
        bytes_moved=total_bytes,
        sol_time_ms=sol_s * 1e3,
        attained_ms=attained_ms,
        efficiency=eff,
    )
