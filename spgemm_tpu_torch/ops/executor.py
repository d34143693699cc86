"""Device-resident executors: build once, run many (port of
`spgemm_tpu/ops/executor.py`: StripExecutor, EscExecutor and
OzakiExecutor).

The packed operands stay resident as tensors on the device; each run is
one kernel launch. `update_values` re-uploads only the value plane(s),
for workloads whose pattern is fixed while values change.
"""

from __future__ import annotations

import numpy as np
import torch

from spgemm_tpu_torch.models.csr import CSR
from spgemm_tpu_torch.models.tile import TileMat
from spgemm_tpu_torch.ops import esc, kernels, scan_kernels
from spgemm_tpu_torch.ops.esc import ScanPlan
from spgemm_tpu_torch.ops.gustavson import (StripArgs, build_strip_args,
                                            check_strip_feasible,
                                            download_compact)
from spgemm_tpu_torch.ops.ozaki import (OzakiPlan, ozaki_assemble,
                                        ozaki_core, slice_and_pack)
from spgemm_tpu_torch.utils.timing import cuda_event_ms, resolve_device


class StripExecutor:
    """Resident-operand executor for the strip route. `device` None
    means CUDA."""

    def __init__(self, a: TileMat, b: TileMat, *, block_rows: int = 32,
                 device=None):
        self.device = resolve_device(device)
        # structural identity of A (exact: pattern arrays kept by ref)
        self.a_struct = (a.tm, a.tn, a.trow, a.tcol, a.tnnz_ptr, a.rc)
        self.shape = (a.m, b.n)
        self.args: StripArgs = build_strip_args(a, b, block_rows=block_rows)
        check_strip_feasible(self.args, self.device)
        self._dev = self.args.to_device(self.device)

    @property
    def nt_c(self) -> int:
        return self.args.nt_c

    def run(self) -> tuple[torch.Tensor, torch.Tensor]:
        """One numeric launch. Returns (c_val, c_cnt) device tensors in the
        block-padded layout (see ops/kernels.py:strip_numeric)."""
        return kernels.strip_numeric(*self._dev, **self.args.kernel_kwargs())

    def run_compact(self) -> TileMat:
        """run() + device-side compaction and picking + TileMat assembly."""
        c_val, c_cnt = self.run()
        return download_compact(c_val, c_cnt, self.args).tilemat(
            self.args.ctrow, self.args.ctcol, self.shape)

    def update_values(self, a: TileMat) -> None:
        """Re-upload A's value plane for a matrix with the SAME sparsity
        structure (pattern-fixed iterative workloads)."""
        if self.a_struct is None:
            raise ValueError(
                "update_values is unavailable on executors built with "
                "from_args (A pattern arrays were not retained)")
        tm0, tn0, trow0, tcol0, tnnz0, rc0 = self.a_struct
        same = (a.tm == tm0 and a.tn == tn0
                and np.array_equal(a.trow, trow0)
                and np.array_equal(a.tcol, tcol0)
                and np.array_equal(a.tnnz_ptr, tnnz0)
                and np.array_equal(a.rc, rc0))
        if not same:
            raise ValueError(
                "update_values requires the exact same tile structure "
                f"(got nt={a.nt} nnz={a.nnz}, built with nt={trow0.size} "
                f"nnz={rc0.size})")
        a_val = np.zeros_like(self.args.a_val)
        a_val[: a.nt] = a.dense(np.float32)
        self.args.a_val = a_val
        self._dev = (torch.from_numpy(a_val).to(self.device),) + self._dev[1:]

    def time_numeric(self, *, warmup: int = 3, iters: int = 50) -> float:
        """Median device milliseconds of one numeric launch (CUDA events
        around each launch after `warmup` untimed ones)."""
        return cuda_event_ms(self.run, warmup=warmup, iters=iters)

    @classmethod
    def from_args(cls, args: StripArgs, *, device=None,
                  shape: tuple[int, int] | None = None) -> "StripExecutor":
        """Wrap an existing plan (e.g. SpGEMMResult.schedule) without
        rebuilding it; update_values is unavailable on such instances."""
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.a_struct = None
        self.shape = shape or (args.gm * args.tm, args.gn_c * args.tn)
        self.args = args
        check_strip_feasible(args, self.device)
        self._dev = args.to_device(self.device)
        return self


class EscExecutor:
    """Resident-operand executor for the ESC scan route (port of
    `spgemm_tpu/ops/executor.py:EscExecutor`). The int16 meta plane and
    the value plane(s) stay on the device; `update_values` refreshes only
    the values, so a pattern-fixed rerun is one upload and one launch.

    mode="premul": the host-premultiplied qv plane (6 B per product, each
    product rounded once from f64). mode="mul": separate (av, bv) planes
    multiplied in the kernel (10 B per product); the device then does one
    multiply per product, so 2*F / kernel time is a device GFLOPS with
    the accounting of the strip kernel. `device` None means CUDA."""

    def __init__(self, plan: ScanPlan, *, mode: str = "premul",
                 device=None):
        if not isinstance(plan, ScanPlan):
            raise TypeError("EscExecutor wraps a ScanPlan; build one with "
                            "build_esc_scan_plan")
        if mode not in ("premul", "mul"):
            raise ValueError(f"mode must be 'premul' or 'mul': {mode!r}")
        self.plan = plan
        self.mode = mode
        self.device = resolve_device(device)
        self._meta = torch.from_numpy(plan.meta16()).to(self.device)
        qv = torch.from_numpy(plan.qv).to(self.device)
        if mode == "premul":
            self._vals = (qv,)
        else:
            # without fresh input values, split the premultiplied plane as
            # (qv, ones): the same products, the same kernel traffic, and
            # still one multiply per product (padding lanes hold qv == 0)
            self._vals = (qv, torch.ones_like(qv))

    def run(self) -> torch.Tensor:
        """One numeric launch; returns the (R/G, 128) device output in
        window-major C slot order."""
        kw = dict(passes=self.plan.passes, group_rows=self.plan.group_rows)
        if self.mode == "premul":
            return scan_kernels.esc_scan(self._vals[0], self._meta, **kw)
        return scan_kernels.esc_scan_mul(self._vals[0], self._vals[1],
                                         self._meta, **kw)

    def run_csr(self) -> CSR:
        """run() + device window combine + host epilogue: C as CSR."""
        res, tail = esc._combine_apply(self.plan, self.run())
        return esc.esc_scan_trim_combined(self.plan, res, tail)

    def update_values(self, a_data: np.ndarray, b_data: np.ndarray) -> None:
        """Pattern-fixed value refresh: gather(+multiply) into fresh value
        plane(s) and upload them; plan.qv is never changed, so other
        executors of the same plan keep their values."""
        plan = self.plan
        if plan.a_src is None:
            raise ValueError(
                "update_values needs a plan built with keep_sources=True")
        if a_data.size and int(plan.a_src.max()) >= a_data.size:
            raise ValueError("a_data is smaller than the plan's A pattern")
        if self.mode == "premul":
            planes = (esc.refresh_qv(plan, a_data, b_data),)
        else:
            planes = esc.gather_planes(plan, a_data, b_data)
        self._vals = tuple(torch.from_numpy(p).to(self.device)
                           for p in planes)

    def time_numeric(self, *, warmup: int = 3, iters: int = 50) -> float:
        """Median device milliseconds of one numeric launch (CUDA events
        around each launch after `warmup` untimed ones)."""
        return cuda_event_ms(self.run, warmup=warmup, iters=iters)


class OzakiExecutor:
    """Resident-operand executor for the Ozaki slab engine (port of
    `spgemm_tpu/ops/executor.py:OzakiExecutor`). The int8 slice planes,
    the int8 occupancy slabs and the seg map stay on the device;
    `update_values(a, b)` re-slices new f64 values for the same tile
    pattern (the base plan and its C-tile dictionary are kept; only
    ops/ozaki.py:slice_and_pack reruns) and uploads only the slice
    planes. The slice counts may change with the values. `device` None
    means CUDA."""

    def __init__(self, plan: OzakiPlan, a: TileMat, b: TileMat, *,
                 device=None):
        if not isinstance(plan, OzakiPlan):
            raise TypeError("OzakiExecutor wraps an OzakiPlan "
                            "(build with build_ozaki_plan)")
        self.plan = plan
        self.device = resolve_device(device)
        # pattern identity for update_values (exact arrays)
        self._struct = (a.tm, a.tn, a.trow.copy(), b.tcol.copy(),
                        a.tnnz_ptr.copy(), b.tnnz_ptr.copy())
        self.shape = (a.m, b.n)
        self._dev = list(plan.to_device(self.device))

    def run(self, sync: bool = True):
        """One numeric step; returns device (c_h, c_m, c_l, c_cnt)."""
        out = ozaki_core(*self._dev, **self.plan.core_kwargs())
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def assemble(self, out) -> np.ndarray:
        """Host epilogue: the (nt_c, tm, tn) f64 values (ozaki_assemble)."""
        return ozaki_assemble(self.plan, *out, self.shape)

    def update_values(self, a: TileMat, b: TileMat) -> None:
        """Pattern-fixed f64 value refresh: re-slice and upload the slice
        planes only."""
        tm0, tn0, trow0, tcol0, annz0, bnnz0 = self._struct
        if not (a.tm == tm0 and a.tn == tn0
                and np.array_equal(a.trow, trow0)
                and np.array_equal(b.tcol, tcol0)
                and np.array_equal(a.tnnz_ptr, annz0)
                and np.array_equal(b.tnnz_ptr, bnnz0)):
            raise ValueError(
                "update_values requires the exact same tile structure")
        plan = self.plan
        (plan.a_sl, plan.b_sl, plan.ea, plan.eb, plan.sa,
         plan.sb) = slice_and_pack(a, b, plan.base)
        self._dev[0] = torch.from_numpy(plan.a_sl).to(self.device)
        self._dev[1] = torch.from_numpy(plan.b_sl).to(self.device)

    def time_numeric(self, *, warmup: int = 3, iters: int = 20) -> float:
        """Median device milliseconds of one numeric step (CUDA events
        around each step after `warmup` untimed ones)."""
        return cuda_event_ms(lambda: self.run(sync=False), warmup=warmup,
                             iters=iters)
