"""CPU emulation of the ESC scan kernel's warp layout (csrc/esc_scan.cu).

The CUDA kernel runs only on the card. Its arithmetic is held here in
torch, step by step as the kernel moves data: one warp per 128-lane row,
thread t holding lanes 4t .. 4t+3 in four registers; doubling step d takes
lane i+d (mod 128) from the thread's own registers and one or two
shuffles from thread t+1 for d = 1, 2, and the same register of thread
(t + d/4) mod 32 for d >= 4; the gather reads a per-warp shared row
written as four lanes per thread; the G rows accumulate left to right.
The emulation must be bit-equal (torch.equal) to the three plain versions
in spgemm_tpu_torch/ops/scan_kernels.py on random and band plans, at
G 1 and 4, for every pass count 0..7. The plans also keep the invariant
the layout leans on: no lane's run reaches past the row (lane + dist <=
127), so no step adds a wrapped value.
"""

import numpy as np
import pytest
import torch

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import scan_kernels as sk
from spgemm_tpu_torch.ops.esc import gather_planes, scan_dd_planes
from spgemm_tpu_torch.utils.generators import banded, random_uniform

LANES = sk.LANES
THREADS = LANES // 4


def _shfl(reg, src_offset):
    """__shfl_sync(reg, (t + src_offset) & 31) on (rows, 32) registers."""
    return torch.roll(reg, -src_offset, dims=1)


def _step_sources(q, d):
    """(rows, 32, 4) registers -> the values of lanes 4t+j+d (mod 128),
    built from registers and shuffles as the kernel builds them."""
    if d == 1:
        regs = [q[..., 1], q[..., 2], q[..., 3], _shfl(q[..., 0], 1)]
    elif d == 2:
        regs = [q[..., 2], q[..., 3], _shfl(q[..., 0], 1),
                _shfl(q[..., 1], 1)]
    else:
        regs = [_shfl(q[..., j], d // 4) for j in range(4)]
    return torch.stack(regs, dim=-1)


def _gather(q, idx, present):
    """The per-warp shared row: four lanes per thread written in order,
    then each lane reads its idx."""
    row = q.reshape(-1, LANES)
    return torch.gather(row, 1, idx) * present


def warp_scan(planes, meta, *, passes, group_rows, mode):
    """The kernel's warp design on the CPU. mode "premul", "mul" or "dd";
    returns what the matching plain version returns."""
    m = meta.to(torch.int32)
    idx = (m & 127).long()
    present = ((m >> 7) & 1).to(torch.float32)
    dist = (m >> 8).view(-1, THREADS, 4)
    if mode == "mul":
        s = planes[0] * planes[1]
    else:
        s = planes[0].clone()
    s = s.view(-1, THREADS, 4)
    e = planes[1].view(-1, THREADS, 4) if mode == "dd" else None
    for k in range(passes):
        d = 1 << k
        ok = dist >= d
        sr = torch.where(ok, _step_sources(s, d), 0.0)
        if mode == "dd":
            er = torch.where(ok, _step_sources(e, d), 0.0)
            s, e = sk.two_sum_acc(s, e, sr, er)
        else:
            s = s + sr
    ys = _gather(s, idx, present).view(-1, group_rows, LANES)
    acc_s = ys[:, 0]
    if mode != "dd":
        for j in range(1, group_rows):
            acc_s = acc_s + ys[:, j]
        return acc_s
    ye = _gather(e, idx, present).view(-1, group_rows, LANES)
    acc_e = ye[:, 0]
    for j in range(1, group_rows):
        acc_s, acc_e = sk.two_sum_acc(acc_s, acc_e, ys[:, j], ye[:, j])
    return acc_s, acc_e


def _plan(kind, group_rows):
    rng = np.random.default_rng(5)
    a = (random_uniform(rng, 1500, 6) if kind == "random"
         else banded(rng, 512, 40, fill=1.0))
    a = a.with_data(rng.standard_normal(a.nnz))
    return a, pt.build_esc_scan_plan(a, a, group_rows=group_rows)


@pytest.mark.parametrize("kind", ["random", "band"])
@pytest.mark.parametrize("group_rows", [1, 4])
def test_plan_keeps_runs_inside_the_row(kind, group_rows):
    _, plan = _plan(kind, group_rows)
    m = plan.meta16().astype(np.int32)
    dist = m >> 8
    lane = np.arange(LANES)[None, :]
    assert (dist >= 0).all()
    assert (lane + dist <= LANES - 1).all()
    if kind == "band":
        assert plan.passes == 7  # runs long enough for every step


@pytest.mark.parametrize("kind", ["random", "band"])
@pytest.mark.parametrize("group_rows", [1, 4])
@pytest.mark.parametrize("passes", range(8))
def test_warp_layout_equals_plain_versions(kind, group_rows, passes):
    a, plan = _plan(kind, group_rows)
    meta = torch.from_numpy(plan.meta16())
    kw = dict(passes=passes, group_rows=group_rows)
    qv = torch.from_numpy(plan.qv)
    av, bv = map(torch.from_numpy, gather_planes(plan, a.data, a.data))
    qh, ql = map(torch.from_numpy, scan_dd_planes(plan, a.data, a.data))
    assert torch.equal(warp_scan((qv,), meta, mode="premul", **kw),
                       sk.esc_scan_plain(qv, meta, **kw))
    assert torch.equal(warp_scan((av, bv), meta, mode="mul", **kw),
                       sk.esc_scan_mul_plain(av, bv, meta, **kw))
    got = warp_scan((qh, ql), meta, mode="dd", **kw)
    exp = sk.esc_scan_dd_plain(qh, ql, meta, **kw)
    assert torch.equal(got[0], exp[0]) and torch.equal(got[1], exp[1])


def test_wrapped_sources_match_the_plain_roll():
    # meta that breaks the plan invariant (runs past the row end): the
    # kernel's wrapping shuffles still reproduce the plain version's roll
    rng = np.random.default_rng(3)
    rows = 64
    q = torch.from_numpy(rng.standard_normal((rows, LANES)).astype(np.float32))
    m = (rng.integers(0, 128, (rows, LANES))
         | (rng.integers(0, 2, (rows, LANES)) << 7)
         | (rng.integers(0, 128, (rows, LANES)) << 8))
    meta = torch.from_numpy(m.astype(np.int16))
    for passes in (3, 7):
        kw = dict(passes=passes, group_rows=2)
        assert torch.equal(warp_scan((q,), meta, mode="premul", **kw),
                           sk.esc_scan_plain(q, meta, **kw))
