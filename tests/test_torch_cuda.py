"""Card-only checks of the PyTorch port: the CUDA strip kernel, the three
ESC scan kernels, the Ozaki strip kernel, the SpMM strip kernel (both its
128-column and its narrow form) and the pair kernel against their plain
PyTorch versions, the register budgets of the strip, Ozaki, pair and
128-column SpMM kernels, the wrappers' refusals, the public entry
points on a CUDA device, long sums of positive products through the
strip, pair and 128-column SpMM kernels, and the six multi-device
formulations on a one-rank mesh of the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: integer values are exact in f32 and must agree exactly;
Gaussian values are summed in another order (rtol 1e-5, atol
1e-6*max|C|; TF32 would miss by ~1e-3, the exact three-way TF32 split
of the strip, pair and 128-column SpMM kernels does not, and neither
does it on long sums of positive products: tests/test_torch_strip_arith.py
emulates it). Counts are exact f32 sums of 0/1
products in both versions and must be equal. The scan kernels add in
their plain versions' order, with no contraction, so they must be
bit-equal to them on any values. So must the Ozaki kernel: its int32
group sums are exact and its TwoSum reduce follows the plain version's
order. `spgemm(backend="esc")` on tiles runs the scan kernels and must
give the CPU's C exactly.

The routes without a hand kernel (gustavson slab, dense, the f64 slab
engine) take every tile shape the kernels do not. They are torch ops and
must give the CPU's C: exactly on integer values, within rtol 1e-5 on
Gaussian values (atomic scatter order), and bit-equal (h, m, l, counts)
in the slab engine, whose int32 sums are exact. They run in full FP32
even with TF32 switched on globally, and restore the caller's flag.
"""

import numpy as np
import pytest
import torch

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.ops import (gather_kernels, golden, kernels,
                                  ozaki_kernels, pair_kernels, scan_kernels,
                                  spmm_kernels)
from spgemm_tpu_torch.ops import spmm as pspmm
from spgemm_tpu_torch.ops.esc import gather_planes, scan_dd_planes
from spgemm_tpu_torch.ops.gustavson import build_strip_args
from spgemm_tpu_torch.ops.ozaki import (OzakiOverflow, build_ozaki_plan,
                                        build_ozaki_strip, ozaki_core)
from spgemm_tpu_torch.ops.symbolic import build_pair_schedule
from spgemm_tpu_torch.tools.probe_dyngather import (CASES as GATHER_CASES,
                                                    case_inputs)
from spgemm_tpu_torch.utils.generators import banded, cantlike, random_uniform
from test_torch_compact import FIELDS as TILE_FIELDS, _assert_same
from test_torch_fuzz import CASES as FUZZ_CASES, _operands as fuzz_operands

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _matrix(values: str, n: int = 3000, band: int = 64):
    rng = np.random.default_rng(5)
    a = banded(rng, n, band)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
    return a


def _assert_close(got, exp, values):
    if values == "integer":
        assert torch.equal(got, exp)
    else:
        scale = exp.abs().max().item()
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
@pytest.mark.parametrize("window", [None, False])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_kernel_matches_plain(card, tm, window, values):
    a = _matrix(values)
    args = build_strip_args(pt.csr_to_tiles(a, tm, 128),
                            pt.csr_to_tiles(a, 128, 128), window=window)
    assert (args.kwin is None) == (window is False)
    ops = args.to_device(card)
    before = (kernels.strip_numeric.kernel_launches,
              kernels.strip_numeric.plain_launches)
    kv, kc = kernels.strip_numeric(*ops, **args.kernel_kwargs())
    pv, pc = kernels.strip_numeric_plain(*ops, **args.kernel_kwargs())
    torch.cuda.synchronize()
    assert (kernels.strip_numeric.kernel_launches,
            kernels.strip_numeric.plain_launches) == (before[0] + 1, before[1])
    _assert_close(kv, pv, values)
    assert torch.equal(kc, pc)


def _wide_range(a, rng):
    """Standard-normal values scaled to magnitudes spanning 1e-3..1e3."""
    return a.with_data(rng.standard_normal(a.nnz)
                       * 10.0 ** rng.uniform(-3, 3, a.nnz))


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
@pytest.mark.parametrize("window", [None, False])
def test_kernel_wide_range_values(card, tm, window):
    # the split products keep f32 accuracy where TF32 alone would miss by
    # ~1e-3
    rng = np.random.default_rng(6)
    a = _wide_range(banded(rng, 3000, 64), rng)
    args = build_strip_args(pt.csr_to_tiles(a, tm, 128),
                            pt.csr_to_tiles(a, 128, 128), window=window)
    ops = args.to_device(card)
    kv, kc = kernels.strip_numeric(*ops, **args.kernel_kwargs())
    pv, pc = kernels.strip_numeric_plain(*ops, **args.kernel_kwargs())
    torch.cuda.synchronize()
    _assert_close(kv, pv, "gaussian")
    assert torch.equal(kc, pc)


@pytest.mark.parametrize("tk", [16, 48, 256])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_kernel_other_inner_tiles(card, tk, values):
    # A tiles 64 x tk, B tiles tk x 128: k staged in 32-deep chunks, the
    # last one zero-filled past tk
    a = _matrix(values, 2000, 64)
    args = build_strip_args(pt.csr_to_tiles(a, 64, tk),
                            pt.csr_to_tiles(a, tk, 128))
    assert args.tk == tk
    ops = args.to_device(card)
    kv, kc = kernels.strip_numeric(*ops, **args.kernel_kwargs())
    pv, pc = kernels.strip_numeric_plain(*ops, **args.kernel_kwargs())
    torch.cuda.synchronize()
    _assert_close(kv, pv, values)
    assert torch.equal(kc, pc)


def test_kernel_rejects_tk_not_multiple_of_8(card):
    a = _matrix("integer", 600, 16)
    at, bt = pt.csr_to_tiles(a, 16, 20), pt.csr_to_tiles(a, 20, 128)
    args = build_strip_args(at, bt)
    with pytest.raises(ValueError, match="tk a multiple of 8"):
        kernels.strip_numeric(*args.to_device(card), **args.kernel_kwargs())
    # the router takes the dense route instead of the strip kernel
    before = kernels.strip_numeric.kernel_launches
    res = pt.spgemm(at, bt, device=card)
    assert res.stats["backend"] == "dense"
    assert kernels.strip_numeric.kernel_launches == before
    got, exp = res.c.to_csr(), pt.spgemm(at, bt, device="cpu").c.to_csr()
    assert got.pattern_equal(exp) and np.array_equal(got.data, exp.data)


def _dirty_cache(card):
    """Leaves NaN in the caching allocator's free blocks, so an output
    allocated with torch.empty next shows any element a kernel leaves
    unwritten."""
    junk = torch.full((1 << 26,), float("nan"), device=card)
    del junk


@pytest.mark.parametrize("tm", [8, 64])
def test_kernel_block_of_many_slot_words(card, tm):
    # a block of 64 tile rows holds 128 A tiles, 384 slot words: several
    # of the producer warp's 32-word ballot passes (and more than the 256
    # words of one pass of the kernel before)
    a = _matrix("integer", 12000, 64)
    args = build_strip_args(pt.csr_to_tiles(a, tm, 128),
                            pt.csr_to_tiles(a, 128, 128), block_rows=64)
    aptr = args.aptr
    words = max((aptr[min(r + 64, args.gm)] - aptr[r]) * args.max_b
                for r in range(0, args.gm, 64))
    assert words > 256
    ops = args.to_device(card)
    kv, kc = kernels.strip_numeric(*ops, **args.kernel_kwargs())
    pv, pc = kernels.strip_numeric_plain(*ops, **args.kernel_kwargs())
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kc, pc)


@pytest.mark.parametrize("tm,tn", [(64, 128), (40, 256)])
def test_kernel_empty_slots_and_tiles_are_zero(card, tm, tn):
    # padded slots no pair reaches (strip) and C tiles without pairs
    # (pair) are written as zero into torch.empty outputs
    a = _matrix("gaussian", 3000, 64)
    args = build_strip_args(pt.csr_to_tiles(a, tm, tn),
                            pt.csr_to_tiles(a, tn, tn))
    ops = args.to_device(card)
    _dirty_cache(card)
    kv, kc = kernels.strip_numeric(*ops, **args.kernel_kwargs())
    torch.cuda.synchronize()
    unused = np.ones(kv.shape[0], bool)
    unused[args.gather_idx] = False
    assert unused.any()
    assert not torch.isnan(kv).any() and not torch.isnan(kc).any()
    assert not kv[torch.from_numpy(unused).to(card)].any()
    at, bt = pt.csr_to_tiles(a, tm, tn), pt.csr_to_tiles(a, tn, tn)
    sched = build_pair_schedule(at, bt)
    ops = list(_pair_ops(at, bt, sched, card, torch.bfloat16))
    # three extra C tiles that no pair reaches, at the front
    ptr = torch.from_numpy(np.concatenate(
        [[0, 0, 0], sched.pair_ptr]).astype(np.int32)).to(card)
    ops[6] = ptr
    _dirty_cache(card)
    gv, gc = pair_kernels.pair_accumulate_cuda(*ops,
                                               num_segments=sched.nt_c + 3)
    pv, pc = pair_kernels.pair_accumulate_plain(*ops,
                                                num_segments=sched.nt_c + 3)
    torch.cuda.synchronize()
    assert not gv[:3].any() and not gc[:3].any()
    _assert_close(gv, pv, "gaussian")
    assert torch.equal(gc, pc)


@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_kernel_slot_of_many_pairs(card, values):
    # A tiles 64 x 8 on a band of 160: a C slot sums about 40 (A tile, B
    # slab) pairs, more than one pair record holds (32)
    a = _matrix(values, 2000, 160)
    args = build_strip_args(pt.csr_to_tiles(a, 64, 8),
                            pt.csr_to_tiles(a, 8, 128))
    blk = np.repeat(np.arange(args.gm), np.diff(args.aptr)) // args.block_rows
    sl = np.asarray(args.slots).reshape(-1, args.max_b)[:blk.size]
    hit = sl < args.max_cblock
    per_slot = np.bincount((blk[:, None] * args.max_cblock + sl)[hit])
    assert per_slot.max() > 32
    ops = args.to_device(card)
    kv, kc = kernels.strip_numeric(*ops, **args.kernel_kwargs())
    pv, pc = kernels.strip_numeric_plain(*ops, **args.kernel_kwargs())
    torch.cuda.synchronize()
    _assert_close(kv, pv, values)
    assert torch.equal(kc, pc)


def test_main_plan_integer_model_bit_equal(card):
    # the cant-like 62,451^2 A^2 at 64x128 (bench.py's plan): C bit-equal
    # to the plain version, counts equal
    a = cantlike(62451, 64)
    args = build_strip_args(pt.csr_to_tiles(a, 64, 128),
                            pt.csr_to_tiles(a, 128, 128))
    ops = args.to_device(card)
    kv, kc = kernels.strip_numeric(*ops, **args.kernel_kwargs())
    pv, pc = kernels.strip_numeric_plain(*ops, **args.kernel_kwargs())
    torch.cuda.synchronize()
    assert torch.equal(kv, pv) and torch.equal(kc, pc)


def _pipeline_usage(info, kernel):
    """ptxas's (registers, spill stores, spill loads) of each height's
    instantiation of a tile-pipeline kernel, and the log."""
    usage = kernels.ptxas_usage(info["ptxas"])
    return {fn: v for fn, v in usage.items() if kernel in fn}, info["ptxas"]


def test_strip_kernel_registers(card):
    # one 384-thread CTA per SM: at most 168 registers a thread at launch
    # (setmaxnreg then moves the producer's to the consumers), no spills,
    # and no wgmma that ptxas serialises (C7511, C7513, C7515)
    kernels.load_strip_kernel()
    usage, log = _pipeline_usage(kernels.build_info, "strip_numeric_kernel")
    assert len(usage) == 4
    assert all(regs <= 168 and st == ld == 0
               for regs, st, ld in usage.values()), usage
    assert kernels.serialised_wgmma(log) == 0


def test_kernel_rejects_unsupported_tiles(card):
    a = _matrix("integer", 200, 8)
    args = build_strip_args(pt.csr_to_tiles(a, 8, 16), pt.csr_to_tiles(a, 16, 16))
    with pytest.raises(ValueError, match="strip kernel takes"):
        kernels.strip_numeric(*args.to_device(card), **args.kernel_kwargs())
    got, res = pt.spgemm_csr(a, tm=8, tn=16, backend="strip", device=card)
    assert res.stats["backend"] == \
        "dense(strip-fallback: no strip kernel for 8x16 tiles with tk 16)"
    exp, _ = pt.spgemm_csr(a, tm=8, tn=16, backend="strip", device="cpu")
    assert got.pattern_equal(exp) and np.array_equal(got.data, exp.data)


def test_spgemm_csr_and_executor_on_card_match_cpu(card):
    a = cantlike(3000, 64)
    before = kernels.strip_numeric.kernel_launches
    gc, res = pt.spgemm_csr(a, tm=64, tn=128, device=card)
    hc, _ = pt.spgemm_csr(a, tm=64, tn=128, device="cpu")
    assert res.stats["backend"] == "strip"
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)
    ex = pt.StripExecutor(pt.csr_to_tiles(a, 64, 128),
                          pt.csr_to_tiles(a, 128, 128), device=card)
    ec = ex.run_compact().to_csr()
    assert ec.pattern_equal(hc) and np.array_equal(ec.data, hc.data)
    assert kernels.strip_numeric.kernel_launches == before + 2
    assert ex.time_numeric(warmup=1, iters=3) > 0


def test_cli_on_card(card, tmp_path, capsys):
    from spgemm_tpu_torch.cli import main

    a = cantlike(2000, 64)
    p = tmp_path / "c.mtx"
    rows = a.rows_expanded() + 1
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.m} {a.n} {a.nnz}\n")
        for r, c, v in zip(rows, a.indices + 1, a.data):
            f.write(f"{r} {c} {v:.17g}\n")
    assert main(["-d", "cuda:0", str(p), "64", "128"]) == 0
    out = capsys.readouterr().out
    assert "check (values vs scipy oracle): [PASSED]" in out


def _scan_matrix(kind: str, values: str):
    rng = np.random.default_rng(9)
    a = (random_uniform(rng, 4000, 8) if kind == "random"
         else banded(rng, 1024, 40, fill=1.0))  # windows > COMBINE_K rows
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
    return a


@pytest.mark.parametrize("kind", ["random", "band"])
@pytest.mark.parametrize("group_rows", [1, 4])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_scan_kernels_match_plain(card, kind, group_rows, values):
    a = _scan_matrix(kind, values)
    plan = pt.build_esc_scan_plan(a, a, group_rows=group_rows)
    meta = torch.from_numpy(plan.meta16()).to(card)
    up = lambda x: torch.from_numpy(x).to(card)
    kw = dict(passes=plan.passes, group_rows=group_rows)
    qv = up(plan.qv)
    av, bv = map(up, gather_planes(plan, a.data, a.data))
    qh, ql = map(up, scan_dd_planes(plan, a.data, a.data))
    cases = ((scan_kernels.esc_scan, scan_kernels.esc_scan_plain, (qv,)),
             (scan_kernels.esc_scan_mul, scan_kernels.esc_scan_mul_plain,
              (av, bv)),
             (scan_kernels.esc_scan_dd, scan_kernels.esc_scan_dd_plain,
              (qh, ql)))
    for wrapper, plain, planes in cases:
        before = (wrapper.kernel_launches, wrapper.plain_launches)
        got = wrapper(*planes, meta, **kw)
        exp = plain(*planes, meta, **kw)
        torch.cuda.synchronize()
        assert (wrapper.kernel_launches, wrapper.plain_launches) == (
            before[0] + 1, before[1])
        for g, e in zip(got if isinstance(got, tuple) else (got,),
                        exp if isinstance(exp, tuple) else (exp,)):
            assert torch.equal(g, e), wrapper.__name__


@pytest.mark.parametrize("group_rows", [2, 8])
@pytest.mark.parametrize("passes", [0, 7])
def test_scan_kernels_groups_passes_and_ragged_rows(card, group_rows,
                                                    passes):
    # a CTA holds 8 warps, one output row each: cut the plan to a row
    # count whose output rows are not a multiple of 8
    a = _scan_matrix("band", "gaussian")
    plan = pt.build_esc_scan_plan(a, a, group_rows=group_rows)
    n_out = plan.qv.shape[0] // group_rows
    assert n_out > 16
    rows = group_rows * (n_out - n_out % 8 - 5)
    up = lambda x: torch.from_numpy(np.ascontiguousarray(x[:rows])).to(card)
    meta = up(plan.meta16())
    kw = dict(passes=passes, group_rows=group_rows)
    cases = ((scan_kernels.esc_scan, scan_kernels.esc_scan_plain,
              (up(plan.qv),)),
             (scan_kernels.esc_scan_mul, scan_kernels.esc_scan_mul_plain,
              tuple(map(up, gather_planes(plan, a.data, a.data)))),
             (scan_kernels.esc_scan_dd, scan_kernels.esc_scan_dd_plain,
              tuple(map(up, scan_dd_planes(plan, a.data, a.data)))))
    for wrapper, plain, planes in cases:
        got = wrapper(*planes, meta, **kw)
        exp = plain(*planes, meta, **kw)
        torch.cuda.synchronize()
        for g, e in zip(got if isinstance(got, tuple) else (got,),
                        exp if isinstance(exp, tuple) else (exp,)):
            assert g.shape == (rows // group_rows, 128)
            assert torch.equal(g, e), wrapper.__name__


def test_scan_kernels_reject_misaligned_planes(card):
    qv = torch.zeros(4 * 128 + 1, dtype=torch.float32, device=card)
    meta = torch.zeros(4 * 128 + 8, dtype=torch.int16, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        scan_kernels.esc_scan(qv[1:].view(4, 128), meta[:512].view(4, 128),
                              passes=1, group_rows=1)


def test_spgemm_tiles_esc_on_card_matches_cpu(card):
    a = _scan_matrix("random", "integer")
    at, bt = pt.csr_to_tiles(a, 16, 128), pt.csr_to_tiles(a, 128, 128)
    w = scan_kernels.esc_scan
    before = (w.kernel_launches, w.plain_launches)
    res = pt.spgemm(at, bt, backend="esc", device=card)
    assert (w.kernel_launches, w.plain_launches) == (before[0] + 1,
                                                     before[1])
    hres = pt.spgemm(at, bt, backend="esc", device="cpu")
    assert res.stats == hres.stats and res.stats["backend"] == "esc"
    gc, hc = res.c.to_csr(), hres.c.to_csr()
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(gc)
    assert got.pattern_equal(ref) and np.array_equal(got.data, ref.data)

    ag = a.with_data(np.random.default_rng(4).standard_normal(a.nnz))
    at, bt = pt.csr_to_tiles(ag, 16, 128), pt.csr_to_tiles(ag, 128, 128)
    w = scan_kernels.esc_scan_dd
    before = w.kernel_launches
    res = pt.spgemm(at, bt, backend="esc", compute_dtype=torch.float64,
                    device=card)
    assert w.kernel_launches == before + 1
    hres = pt.spgemm(at, bt, backend="esc", compute_dtype=torch.float64,
                     device="cpu")
    gc, hc = res.c.to_csr(), hres.c.to_csr()
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)


def test_esc_entry_points_on_card_match_cpu(card):
    a = _scan_matrix("random", "integer")
    before = scan_kernels.esc_scan.kernel_launches
    gc, res = pt.spgemm_csr(a, device=card)
    hc, _ = pt.spgemm_csr(a, device="cpu")
    assert res.stats["backend"] == "esc" and res.c is None
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(gc)
    assert got.pattern_equal(ref) and np.array_equal(got.data, ref.data)
    assert scan_kernels.esc_scan.kernel_launches == before + 1
    for mode in ("premul", "mul"):
        ex = pt.EscExecutor(res.schedule, mode=mode, device=card)
        ec = ex.run_csr()
        assert ec.pattern_equal(hc) and np.array_equal(ec.data, hc.data)
        assert ex.time_numeric(warmup=1, iters=3) > 0

    ag = a.with_data(np.random.default_rng(2).standard_normal(a.nnz))
    before = scan_kernels.esc_scan_dd.kernel_launches
    gc, res = pt.spgemm_csr(ag, compute_dtype=torch.float64, device=card)
    hc, _ = pt.spgemm_csr(ag, compute_dtype=torch.float64, device="cpu")
    assert scan_kernels.esc_scan_dd.kernel_launches == before + 1
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)


def test_esc_plan_used_on_cpu_then_card(card):
    a = _scan_matrix("band", "integer")
    plan = pt.build_esc_scan_plan(a, a)
    hc = pt.EscExecutor(plan, device="cpu").run_csr()
    gc = pt.EscExecutor(plan, device=card).run_csr()
    assert sorted(plan._combine_dev) == ["cpu", "cuda:0"]
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)


def test_cli_esc_f64_on_card(card, tmp_path, capsys):
    from spgemm_tpu_torch.cli import main

    a = _scan_matrix("random", "gaussian")
    p = tmp_path / "u.mtx"
    rows = a.rows_expanded() + 1
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.m} {a.n} {a.nnz}\n")
        for r, c, v in zip(rows, a.indices + 1, a.data):
            f.write(f"{r} {c} {v:.17g}\n")
    assert main(["-d", "cuda:0", str(p), "--dtype", "f64"]) == 0
    out = capsys.readouterr().out
    assert "numtile(C): 0" in out
    assert "check (values vs scipy oracle): [PASSED]" in out


def _ozaki_plan(tm: int, case: str):
    rng = np.random.default_rng(21)
    a = banded(rng, 2000, 64)
    if case == "integer":
        x = y = a
    else:
        x = a.with_data(rng.standard_normal(a.nnz))
        y = x if case == "gaussian" else a.with_data(
            rng.integers(-2 ** 20, 2 ** 20, a.nnz).astype(np.float64))
    return build_ozaki_strip(pt.csr_to_tiles(x, tm, 128),
                             pt.csr_to_tiles(y, 128, 128))


@pytest.mark.parametrize("tm", [16, 32])
@pytest.mark.parametrize("case,sizes,pmax", [
    ("integer", (1, 1), None), ("gaussian", (8, 8), None),
    ("gaussian", (8, 8), 14), ("gaussian-x-wide-int", (8, 3), None),
    ("gaussian-x-wide-int", (8, 3), 2)])
def test_ozaki_kernel_matches_plain(card, tm, case, sizes, pmax):
    plan = _ozaki_plan(tm, case)
    assert (plan.sa, plan.sb) == sizes
    ops = plan.to_device(card)
    kw = plan.kernel_kwargs()
    if pmax is not None:
        kw["pmax"] = pmax
    w = ozaki_kernels.ozaki_strip_numeric
    before = (w.kernel_launches, w.plain_launches)
    got = w(*ops, **kw)
    exp = ozaki_kernels.ozaki_strip_numeric_plain(*ops, **kw)
    torch.cuda.synchronize()
    assert (w.kernel_launches, w.plain_launches) == (before[0] + 1,
                                                     before[1])
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.mark.parametrize("tk", [48, 256])
def test_ozaki_kernel_other_inner_tiles(card, tk):
    # A tiles 32 x tk, B tiles tk x 128: k staged in 128-deep chunks with a
    # zero-filled tail
    rng = np.random.default_rng(22)
    a = banded(rng, 1500, 64)
    a = a.with_data(rng.standard_normal(a.nnz))
    plan = build_ozaki_strip(pt.csr_to_tiles(a, 32, tk),
                             pt.csr_to_tiles(a, tk, 128))
    ops = plan.to_device(card)
    got = ozaki_kernels.ozaki_strip_numeric(*ops, **plan.kernel_kwargs())
    exp = ozaki_kernels.ozaki_strip_numeric_plain(*ops,
                                                  **plan.kernel_kwargs())
    torch.cuda.synchronize()
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


def _ozaki_check(card, plan, pmax):
    ops = plan.to_device(card)
    kw = plan.kernel_kwargs()
    if pmax is not None:
        kw["pmax"] = pmax
    got = ozaki_kernels.ozaki_strip_numeric(*ops, **kw)
    exp = ozaki_kernels.ozaki_strip_numeric_plain(*ops, **kw)
    torch.cuda.synchronize()
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    return got


@pytest.mark.parametrize("tm", [16, 32])
@pytest.mark.parametrize("pmax", [None, 14])
def test_ozaki_kernel_slot_with_many_pairs(card, tm, pmax):
    # one 32-row tile row over 300 k tiles of 16, against 300 B tiles in one
    # column: each C slot sums 300 (g, y) entries, more than one gather
    # (256) holds; Gaussian values, S = 8x8 (pmax 7 and all 15 groups)
    rng = np.random.default_rng(23)
    kt, tk = 300, 16
    ar = np.repeat(np.arange(32), 4 * kt)
    ac = (np.tile(np.arange(kt), 32 * 4) * tk
          + rng.integers(0, tk, ar.size))
    a = pt.CSR.from_coo(ar, ac, rng.standard_normal(ar.size), (32, kt * tk))
    br = np.repeat(np.arange(kt * tk), 3)
    bc = rng.integers(0, 128, br.size)
    b = pt.CSR.from_coo(br, bc, rng.standard_normal(br.size), (kt * tk, 128))
    plan = build_ozaki_strip(pt.csr_to_tiles(a, tm, tk),
                             pt.csr_to_tiles(b, tk, 128))
    assert (plan.sa, plan.sb) == (8, 8)
    s = plan.sargs
    hits = np.bincount(s.slots[s.slots < s.max_cblock])
    assert hits.max() > 256
    got = _ozaki_check(card, plan, pmax)
    assert bool((got[3] > 0).any())


@pytest.mark.parametrize("tm", [16, 32])
@pytest.mark.parametrize("pmax", [None, 14])
def test_ozaki_kernel_padded_slots_are_zero(card, tm, pmax):
    # a banded first block and an almost empty second one: most of the
    # second block's padded slots are reached by no pair
    rng = np.random.default_rng(24)
    a = banded(rng, 1800, 64)
    rows = a.rows_expanded()
    keep = (rows < 32 * tm) | ((rows < 32 * tm + 8) & (a.indices == rows))
    a = pt.CSR.from_coo(rows[keep], a.indices[keep],
                        rng.standard_normal(int(keep.sum())), a.shape)
    plan = build_ozaki_strip(pt.csr_to_tiles(a, tm, 128),
                             pt.csr_to_tiles(a, 128, 128))
    s = plan.sargs
    n_slots = -(-s.gm // s.block_rows) * s.max_cblock
    tile_row = np.repeat(np.arange(s.gm), np.diff(s.aptr))
    blk = np.repeat(tile_row // s.block_rows, s.max_b)
    sl = s.slots[: s.aptr[-1] * s.max_b]
    live = sl < s.max_cblock
    reached = np.zeros(n_slots, bool)
    reached[blk[live] * s.max_cblock + sl[live]] = True
    assert (~reached).sum() > 0
    got = _ozaki_check(card, plan, pmax)
    idle = torch.from_numpy(~reached).to(card)
    for g in got:
        assert not bool(g[idle].any())
        assert bool(g[~idle].any())


def test_ozaki_kernel_registers(card):
    # one 384-thread CTA per SM (two consumer warpgroups and a producer
    # one) launches at <= 168 registers a thread; ptxas must not
    # serialise the wgmmas (C7511, C7513, C7515); the heights 32, 16 and 8
    # for up to 8 groups, 16 and 8 for all 15. Only the main plan's
    # instantiation (32
    # rows, 8 groups: 144 accumulator registers) spills, 72 bytes of loop
    # state on an H100 build (PERF.md)
    ozaki_kernels.load_ozaki_kernel()
    log = ozaki_kernels.build_info["ptxas"]
    usage = kernels.ptxas_usage(log)
    inst = {fn: v for fn, v in usage.items() if "ozaki_wgmma_kernel" in fn}
    assert len(inst) == 5
    assert kernels.serialised_wgmma(log) == 0
    for fn, (regs, spill_stores, spill_loads) in inst.items():
        assert regs <= 168
        if "ILi32ELi8EE" not in fn:
            assert spill_stores == spill_loads == 0
        else:
            assert spill_stores <= 72


def test_ozaki_entry_points_on_card_match_cpu(card):
    a0 = cantlike(3000, 64)
    a = a0.with_data(np.random.default_rng(0).standard_normal(a0.nnz))
    w = ozaki_kernels.ozaki_strip_numeric
    before = (w.kernel_launches, w.plain_launches)
    gc, res = pt.spgemm_csr(a, tm=32, compute_dtype=torch.float64,
                            device=card)
    # Gaussian rows span more bits than the slices: the four hi/lo passes
    assert res.stats["ozaki_passes"] == 4
    assert (w.kernel_launches, w.plain_launches) == (before[0] + 4,
                                                     before[1])
    assert res.stats["backend"] == "ozaki-strip(S=8x8)"
    hc, _ = pt.spgemm_csr(a, tm=32, compute_dtype=torch.float64,
                          device="cpu")
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(gc)
    assert got.pattern_equal(ref)
    scale = np.abs(ref.data).max()
    assert np.abs(got.data - ref.data).max() <= 1e-12 * scale

    before = w.kernel_launches
    res = pt.spgemm(pt.csr_to_tiles(a0, 16, 128),
                    pt.csr_to_tiles(a0, 128, 128), backend="ozaki",
                    device=card)
    assert w.kernel_launches == before + 1
    assert res.stats["backend"] == "ozaki-strip(S=1x1)"
    got = golden.drop_explicit_zeros(res.c.to_csr())
    ref = golden.spgemm_scipy(a0, a0)
    assert got.pattern_equal(ref) and np.array_equal(got.data, ref.data)

    empty = pt.CSR.from_coo([], [], np.zeros(0), (300, 300))
    res = pt.spgemm(pt.csr_to_tiles(empty, 32, 128),
                    pt.csr_to_tiles(empty, 128, 128), backend="ozaki",
                    device=card)
    assert res.c.nnz == 0 and res.stats["numblkC"] == 0


def test_ozaki_rejects_unsupported_tiles(card):
    a = cantlike(600, 16).with_data(
        np.random.default_rng(1).standard_normal(cantlike(600, 16).nnz))
    # tm 12 is outside the kernel's tiles (tm % 8): the slab engine runs
    # instead, and neither the kernel nor its plain version does
    w = ozaki_kernels.ozaki_strip_numeric
    before = (w.kernel_launches, w.plain_launches)
    got, res = pt.spgemm_csr(a, tm=12, compute_dtype=torch.float64,
                             device=card)
    assert res.stats["backend"] == "ozaki(S=8x8)(xla-fallback)"
    assert (w.kernel_launches, w.plain_launches) == before
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(got)
    assert got.pattern_equal(ref)
    assert np.abs(got.data - ref.data).max() <= \
        1e-12 * np.abs(ref.data).max()
    # the wrapper raises on such a plan (tk 120: tk % 16) and runs no
    # plain version
    plan = build_ozaki_strip(pt.csr_to_tiles(a, 8, 120),
                             pt.csr_to_tiles(a, 120, 128))
    with pytest.raises(ValueError, match="Ozaki strip kernel takes"):
        ozaki_kernels.ozaki_strip_numeric(*plan.to_device(card),
                                          **plan.kernel_kwargs())
    assert (w.kernel_launches, w.plain_launches) == before


def test_cli_ozaki_on_card(card, tmp_path, capsys):
    from spgemm_tpu_torch.cli import main

    a0 = cantlike(2000, 64)
    a = a0.with_data(np.random.default_rng(3).standard_normal(a0.nnz))
    p = tmp_path / "g.mtx"
    rows = a.rows_expanded() + 1
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.m} {a.n} {a.nnz}\n")
        for r, c, v in zip(rows, a.indices + 1, a.data):
            f.write(f"{r} {c} {v:.17g}\n")
    for extra in (["--dtype", "f64"], ["--backend", "ozaki"]):
        assert main(["-d", "cuda:0", str(p), "32", "128"] + extra) == 0
        out = capsys.readouterr().out
        assert "check (values vs scipy oracle): [PASSED]" in out


def _write_mtx(path, a):
    rows = a.rows_expanded() + 1
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.m} {a.n} {a.nnz}\n")
        for r, c, v in zip(rows, a.indices + 1, a.data):
            f.write(f"{r} {c} {v:.17g}\n")


def _spmm_matrix(values: str):
    """Banded 2500^2 with two empty row ranges, so some tile rows (and, at
    every tile height, whole row groups of the 128-column kernel) have no
    tiles."""
    a = _matrix(values, 2500, 64)
    r = a.rows_expanded()
    keep = ((r < 300) | (r >= 700)) & ((r < 1500) | (r >= 1530))
    return pt.CSR.from_coo(r[keep], a.indices[keep], a.data[keep], a.shape)


@pytest.fixture
def nan_empty(monkeypatch):
    """torch.empty returns NaN-filled tensors while it is on, so a kernel
    output the wrapper allocates shows every element it fails to write."""
    real = torch.empty

    def empty(*args, **kw):
        return real(*args, **kw).fill_(float("nan"))

    monkeypatch.setattr(torch, "empty", empty)
    return monkeypatch


@pytest.mark.parametrize("tm", [8, 16, 32, 64, 24, 128])
@pytest.mark.parametrize("tk", [16, 18, 128, 48, 40, 6])
@pytest.mark.parametrize("k_pad", [128, 256, 384])
def test_spmm_kernel_matches_plain(card, nan_empty, tm, tk, k_pad):
    """The 128-column form at every compiled height (8, 16, 32, 64) and two
    chunked ones (24: three 8-row sub-tiles; 128: two of 64), k_pad 128,
    256 and 384, resident and windowed, tk 128, 48, 40 and 16 (ragged
    32-deep stages) and 18 and 6 (A's rows not 16-byte strided: the
    wrapper pads them). Y comes out of a NaN-filled allocation; block_rows
    6 makes the kernel's row groups (64/h virtual rows) span block edges
    and leaves the last group past gm; two empty row ranges leave whole
    groups without a tile: integer X bit-equal to the plain version,
    Gaussian X within rtol 1e-5, atol 1e-6*max|Y|, every row written."""
    rng = np.random.default_rng(31)
    for values in ("integer", "gaussian"):
        a = _spmm_matrix(values)
        t = pt.csr_to_tiles(a, tm, tk)
        x = (rng.integers(-4, 5, (a.n, k_pad - 3)).astype(np.float64)
             if values == "integer" else rng.standard_normal((a.n, k_pad - 3)))
        block_rows = 6
        stats = pspmm._spmm_block_stats(t, block_rows)
        ops = pspmm._pack_spmm_operands(t, x, k_pad, torch.float32,
                                        block_rows).to_device(card)
        kmin = torch.from_numpy(pspmm._window_kmin(t, stats)).to(card)
        w = spmm_kernels.spmm_strip
        for form in (None, kmin):
            before = (w.kernel_launches, w.plain_launches)
            got = w(*ops, form, gm=t.gm, block_rows=block_rows)
            exp = spmm_kernels.spmm_strip_plain(*ops, form, gm=t.gm,
                                                block_rows=block_rows)
            torch.cuda.synchronize()
            assert (w.kernel_launches, w.plain_launches) == (before[0] + 1,
                                                             before[1])
            assert not torch.isnan(got).any()
            _assert_close(got, exp, values)
            assert not got[t.gm:].any()  # the block padding rows


def test_spmm_kernel_wide_range_values(card):
    # split products on both operands (A and X far from TF32 values)
    rng = np.random.default_rng(34)
    a0 = _spmm_matrix("integer")
    a = _wide_range(a0, rng)
    t = pt.csr_to_tiles(a, 16, 128)
    x = rng.standard_normal((a.n, 256)) * 10.0 ** rng.uniform(-3, 3,
                                                               (a.n, 256))
    ops = pspmm._pack_spmm_operands(t, x, 256, torch.float32,
                                    8).to_device(card)
    got = spmm_kernels.spmm_strip(*ops, gm=t.gm, block_rows=8)
    exp = spmm_kernels.spmm_strip_plain(*ops, gm=t.gm, block_rows=8)
    _assert_close(got, exp, "gaussian")


def _absent_rows_case(tm, seed=37):
    """1024^2 in tm x 128 tiles, each (tile row, 128-column block) tile
    present with probability 1/2 (integer values, 30% dense inside), so
    on every X slab some tile rows of a row group have a tile and their
    neighbours have none."""
    rng = np.random.default_rng(seed)
    n = 1024
    on = rng.random((n // tm, n // 128)) < 0.5
    on[:, 0] = True
    d = np.kron(on, np.ones((tm, 128))) * (rng.random((n, n)) < 0.3)
    d = d * rng.integers(1, 10, (n, n))
    a = pt.CSR.from_dense(d.astype(np.float64))
    return a, pt.csr_to_tiles(a, tm, 128), rng


@pytest.mark.parametrize("tm", [8, 16])
@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_spmm_kernel_nonfinite_x_absent_rows_as_plain(card, tm, bad):
    """NaN, and separately +inf, in X rows of slabs on which only some of
    a row group's tile rows have a tile: Y is non-finite where the plain
    version's (the dense tile products) is, and nowhere else; a row with
    no tile on the slab gets nothing from it. The exact split turns a*inf
    into NaN where the plain version gives inf, so the positions are
    compared by isfinite, and the finite entries within rtol 1e-5."""
    a, t, rng = _absent_rows_case(tm)
    x = rng.standard_normal((a.n, 128))
    for r, c in ((300, 5), (301, 5), (700, 77), (1000, 127)):
        x[r, c] = bad
    packed = pspmm._pack_spmm_operands(t, x, 128, torch.float32, 4)
    stats = pspmm._spmm_block_stats(t, 4)
    kmin = torch.from_numpy(pspmm._window_kmin(t, stats)).to(card)
    ops = packed.to_device(card)
    for form in (None, kmin):
        got = spmm_kernels.spmm_strip(*ops, form, gm=t.gm, block_rows=4)
        exp = spmm_kernels.spmm_strip_plain(*ops, form, gm=t.gm,
                                            block_rows=4)
        torch.cuda.synchronize()
        fin = torch.isfinite(exp)
        # the case arises: in the bad columns, some tile rows are finite
        assert bool(fin[:, :, 5].any()) and not bool(fin[:, :, 5].all())
        wrong = torch.isfinite(got) != fin
        assert not wrong.any(), (
            f"{int(wrong.sum())} of {fin.numel()} entries ({int(fin.sum())} "
            f"finite in the plain version) differ in finiteness, in "
            f"{int(wrong.any(2).any(1).sum())} tile rows")
        _assert_close(torch.where(fin, got, 0), torch.where(fin, exp, 0),
                      "gaussian")


@pytest.mark.parametrize("tm", [8, 16, 64])
@pytest.mark.parametrize("tk", [18, 128])
@pytest.mark.parametrize("width,k", [(1, 1), (8, 1), (8, 5), (16, 1),
                                     (16, 5), (32, 1), (32, 5), (32, 32)])
def test_spmm_narrow_kernel_matches_plain(card, tm, tk, width, k):
    rng = np.random.default_rng(33)
    for values in ("integer", "gaussian"):
        a = _matrix(values, 2500, 64)
        t = pt.csr_to_tiles(a, tm, tk)
        x = (rng.integers(-4, 5, (a.n, k)).astype(np.float64)
             if values == "integer" else rng.standard_normal((a.n, k)))
        block_rows = 8
        stats = pspmm._spmm_block_stats(t, block_rows)
        packed = pspmm._pack_spmm_operands(t, x, width, torch.float32,
                                           block_rows)
        ops, smap = packed.to_device(card), packed.sector_map_to(card)
        kmin = torch.from_numpy(pspmm._window_kmin(t, stats)).to(card)
        w = spmm_kernels.spmm_strip
        for form in (None, kmin):
            before = (w.kernel_launches, w.narrow_launches, w.plain_launches)
            got = w(*ops, form, gm=t.gm, block_rows=block_rows, smap=smap)
            exp = spmm_kernels.spmm_strip_plain(*ops, form, gm=t.gm,
                                                block_rows=block_rows)
            torch.cuda.synchronize()
            assert (w.kernel_launches, w.narrow_launches,
                    w.plain_launches) == (before[0] + 1, before[1] + 1,
                                          before[2])
            assert got.shape == exp.shape and got.shape[2] == width
            _assert_close(got, exp, values)


def _narrow_case(tm, width, seed, *, density=0.3):
    """A 1024^2 matrix in tm x 128 tiles: every third 8-column sector
    empty, the rest at `density`, and the first tile row fully dense."""
    rng = np.random.default_rng(seed)
    n = 1024
    d = (rng.random((n, n)) < density) * rng.integers(1, 9, (n, n))
    d[:, (np.arange(n) // 8) % 3 == 0] = 0           # empty sectors
    d[:tm, :] = rng.integers(1, 9, (tm, n))          # dense tiles
    a = pt.CSR.from_dense(d.astype(np.float64))
    return a, pt.csr_to_tiles(a, tm, 128), rng


@pytest.mark.parametrize("tm", [8, 16, 24, 64, 128])
@pytest.mark.parametrize("width", [1, 8, 16, 32])
def test_spmm_narrow_sectors_dense_and_empty(card, tm, width):
    """The narrow form at every width and tile height: integer values are
    bit-equal to the plain version with empty sectors skipped and fully
    dense tiles read whole; the sector map marks both."""
    a, t, rng = _narrow_case(tm, width, 61)
    x = rng.integers(-4, 5, (a.n, width)).astype(np.float64)
    packed = pspmm._pack_spmm_operands(t, x, width, torch.float32, 4)
    bits = np.unpackbits(packed.smap.view(np.uint8), axis=1,
                         bitorder="little")
    assert bits[:t.nt].any(axis=1).all() and not bits[:t.nt].all()
    ops, smap = packed.to_device(card), packed.sector_map_to(card)
    got = spmm_kernels.spmm_strip(*ops, gm=t.gm, block_rows=4, smap=smap)
    exp = spmm_kernels.spmm_strip_plain(*ops, gm=t.gm, block_rows=4)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


@pytest.mark.parametrize("tm", [8, 16, 64, 128])
@pytest.mark.parametrize("width", [1, 8, 16, 32])
def test_spmm_narrow_nonfinite_x_as_plain(card, tm, width):
    """inf and NaN in X reach Y as the dense product gives them: 0 * inf in
    a skipped sector is NaN there too."""
    a, t, rng = _narrow_case(tm, width, 62)
    x = rng.standard_normal((a.n, width))
    x[5, 0] = np.inf
    x[300, 1 % width] = -np.inf
    x[301, 1 % width] = np.inf
    x[700, width - 1] = np.nan
    packed = pspmm._pack_spmm_operands(t, x, width, torch.float32, 4)
    ops, smap = packed.to_device(card), packed.sector_map_to(card)
    got = spmm_kernels.spmm_strip(*ops, gm=t.gm, block_rows=4, smap=smap)
    exp = spmm_kernels.spmm_strip_plain(*ops, gm=t.gm, block_rows=4)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(exp))
    assert torch.equal(torch.isinf(got), torch.isinf(exp))
    fin = torch.isfinite(exp)
    assert bool(torch.isnan(exp).any())
    # at width 1 every row meets a non-finite X value in some tile (0*inf
    # where its sector is empty), so no value is finite there
    assert bool(fin.any()) == (width > 1)
    _assert_close(torch.where(fin, got, 0), torch.where(fin, exp, 0),
                  "gaussian")


@pytest.mark.parametrize("tm", [16, 128])
@pytest.mark.parametrize("width", [1, 8])
def test_spmm_narrow_long_positive_sums(card, tm, width):
    a, _ = long_positive_sums()
    x = np.random.default_rng(23).random((a.n, 1))
    t = pt.csr_to_tiles(a, tm, 128)
    packed = pspmm._pack_spmm_operands(t, x, width, torch.float32, 8)
    y = spmm_kernels.spmm_strip(*packed.to_device(card), gm=t.gm,
                                block_rows=8,
                                smap=packed.sector_map_to(card))
    got = y.reshape(-1, width)[: a.m, :1].double().cpu().numpy()
    f32 = lambda v: v.astype(np.float32).astype(np.float64)
    ref = f32(a.to_dense()) @ f32(x)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_spmm_narrow_needs_the_sector_map(card):
    a = _matrix("integer", 400, 8)
    t = pt.csr_to_tiles(a, 16, 128)
    packed = pspmm._pack_spmm_operands(t, np.ones((a.n, 1)), 8,
                                       torch.float32, 4)
    w = spmm_kernels.spmm_strip
    before = (w.kernel_launches, w.plain_launches)
    with pytest.raises(ValueError, match="sector map"):
        w(*packed.to_device(card), gm=t.gm, block_rows=4)
    assert (w.kernel_launches, w.plain_launches) == before


def _pair_ops(at, bt, sched, card, occ):
    up = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(card)
    return (up(at.dense(np.float32)), up(at.occ()).to(occ),
            up(bt.dense(np.float32)), up(bt.occ()).to(occ), up(sched.pa),
            up(sched.pb), up(sched.pair_ptr))


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
@pytest.mark.parametrize("tk", [1, 7, 16, 100, 128])
@pytest.mark.parametrize("occ", [torch.float32, torch.bfloat16])
def test_pair_kernel_matches_plain(card, tm, tk, occ):
    # tk 1, 7 and 100: A rows padded to a multiple of 8 by the wrapper;
    # tk 1 and 7 give C tiles of many pairs, tk 128 of one or two
    for values in ("integer", "gaussian"):
        a = _matrix(values, 700 if tk < 16 else 1500, 64)
        at, bt = pt.csr_to_tiles(a, tm, tk), pt.csr_to_tiles(a, tk, 128)
        sched = build_pair_schedule(at, bt)
        ops = _pair_ops(at, bt, sched, card, occ)
        w = pair_kernels.pair_accumulate_cuda
        before = (w.kernel_launches, w.plain_launches)
        gv, gc = w(*ops, num_segments=sched.nt_c)
        pv, pc = pair_kernels.pair_accumulate_plain(*ops,
                                                    num_segments=sched.nt_c)
        torch.cuda.synchronize()
        assert (w.kernel_launches, w.plain_launches) == (before[0] + 1,
                                                         before[1])
        _assert_close(gv, pv, values)
        assert torch.equal(gc, pc)


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
@pytest.mark.parametrize("tk", [7, 40])
def test_pair_kernel_tiles_of_0_1_and_many_pairs(card, tm, tk):
    # C tiles with no pair (zero), one pair and nine pairs, in one launch
    rng = np.random.default_rng(35)
    a_val = rng.standard_normal((5, tm, tk)).astype(np.float32)
    b_val = rng.standard_normal((4, tk, 128)).astype(np.float32)
    a_val[a_val < -1.0] = 0.0
    b_val[b_val < -1.0] = 0.0
    pa = np.array([3, 0, 1, 2, 3, 4, 0, 1, 2, 3], np.int32)
    pb = np.array([1, 0, 1, 2, 3, 0, 1, 2, 3, 0], np.int32)
    pair_ptr = np.array([0, 0, 1, 1, 10, 10], np.int32)
    up = lambda v: torch.from_numpy(v).to(card)
    ops = (up(a_val), up(a_val != 0).float(), up(b_val),
           up(b_val != 0).to(torch.bfloat16), up(pa), up(pb), up(pair_ptr))
    gv, gc = pair_kernels.pair_accumulate_cuda(*ops, num_segments=5)
    pv, pc = pair_kernels.pair_accumulate_plain(*ops, num_segments=5)
    _assert_close(gv, pv, "gaussian")
    assert torch.equal(gc, pc)
    for i in (0, 2, 4):
        assert not gv[i].any() and not gc[i].any()


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
@pytest.mark.parametrize("tk", [20, 200])
def test_pair_kernel_ragged_k_tails(card, tm, tk):
    # tk 20 and 200: the last 32-deep stage runs past tk, which the TMA
    # maps zero-fill (A's rows are padded to 24 and 200 columns)
    for values in ("integer", "gaussian"):
        a = _matrix(values, 1500, 64)
        at, bt = pt.csr_to_tiles(a, tm, tk), pt.csr_to_tiles(a, tk, 128)
        sched = build_pair_schedule(at, bt)
        ops = _pair_ops(at, bt, sched, card, torch.bfloat16)
        gv, gc = pair_kernels.pair_accumulate_cuda(*ops,
                                                   num_segments=sched.nt_c)
        pv, pc = pair_kernels.pair_accumulate_plain(*ops,
                                                    num_segments=sched.nt_c)
        torch.cuda.synchronize()
        _assert_close(gv, pv, values)
        assert torch.equal(gc, pc)


def test_pair_and_spmm_kernel_registers(card):
    # the pair kernel runs the strip kernel's pipeline, and SpMM's
    # 128-column form a sibling of it: one 384-thread CTA per SM, at most
    # 168 registers a thread at launch, no spills and no serialised wgmma
    # (C7511, C7513, C7515) at any height
    pair_kernels.load_pair_kernel()
    spmm_kernels.load_spmm_kernel()
    pair, log = _pipeline_usage(pair_kernels.build_info,
                                "pair_accumulate_kernel")
    assert len(pair) == 4
    assert all(regs <= 168 and st == ld == 0
               for regs, st, ld in pair.values()), pair
    assert kernels.serialised_wgmma(log) == 0
    spmm, log = _pipeline_usage(spmm_kernels.build_info, "spmm_wgmma_kernel")
    assert len(spmm) == 4
    assert all(regs <= 168 and st == ld == 0
               for regs, st, ld in spmm.values()), spmm
    assert kernels.serialised_wgmma(log) == 0
    usage = kernels.ptxas_usage(spmm_kernels.build_info["ptxas"])
    # the narrow form: every height and width (1, 8, 16, 32), none
    # spilling
    narrow = [v for fn, v in usage.items() if "spmm_narrow_kernel" in fn]
    assert len(narrow) == 16
    assert all(st == ld == 0 for _, st, ld in narrow)


def test_spmm_and_pair_kernels_reject(card):
    a = _matrix("integer", 400, 8)
    t = pt.csr_to_tiles(a, 12, 16)
    ops = pspmm._pack_spmm_operands(t, np.ones((a.n, 4)), 128, torch.float32,
                                    4).to_device(card)
    with pytest.raises(ValueError, match="SpMM kernel takes tm"):
        spmm_kernels.spmm_strip(*ops, gm=t.gm, block_rows=4)
    t16 = pt.csr_to_tiles(a, 16, 16)
    ops64 = pspmm._pack_spmm_operands(t16, np.ones((a.n, 4)), 128,
                                      torch.float64, 4).to_device(card)
    with pytest.raises(ValueError, match="float32"):
        spmm_kernels.spmm_strip(*ops64, gm=t16.gm, block_rows=4)
    with pytest.raises(ValueError, match="infeasible"):
        pt.spmm(t, np.ones((a.n, 4)), backend="strip", device=card)
    ops16 = list(pspmm._pack_spmm_operands(t16, np.ones((a.n, 4)), 128,
                                           torch.float32, 4).to_device(card))
    shifted = torch.empty(ops16[1].numel() + 1, device=card)[1:]
    ops16[1] = shifted.view_as(ops16[1]).copy_(ops16[1])  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        spmm_kernels.spmm_strip(*ops16, gm=t16.gm, block_rows=4)

    at, bt = pt.csr_to_tiles(a, 8, 16), pt.csr_to_tiles(a, 16, 16)
    sched = build_pair_schedule(at, bt)
    up = lambda v: torch.from_numpy(np.ascontiguousarray(v)).to(card)
    pops = [up(at.dense(np.float32)), up(at.occ()).float(),
            up(bt.dense(np.float32)), up(bt.occ()).float(), up(sched.pa),
            up(sched.pb), up(sched.pair_ptr)]
    with pytest.raises(ValueError, match="pair kernel takes"):
        pair_kernels.pair_accumulate_cuda(*pops, num_segments=sched.nt_c)
    t16p = pt.csr_to_tiles(a, 16, 16)
    sp = build_pair_schedule(t16p, pt.csr_to_tiles(a, 16, 128))
    bq = pt.csr_to_tiles(a, 16, 128)
    qops = [up(t16p.dense(np.float32)), up(t16p.occ()).float(),
            up(bq.dense(np.float32)), up(bq.occ()).float(), up(sp.pa),
            up(sp.pb), up(sp.pair_ptr)]
    shifted = torch.empty(qops[2].numel() + 1, device=card)[1:]
    qops[2] = shifted.view_as(qops[2]).copy_(qops[2])  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        pair_kernels.pair_accumulate_cuda(*qops, num_segments=sp.nt_c)
    pops[0] = pops[0].double()
    with pytest.raises(ValueError, match="float64"):
        pair_kernels.pair_accumulate_cuda(*pops, num_segments=sched.nt_c)
    with pytest.raises(NotImplementedError, match="pair kernel takes"):
        pt.spgemm(at, bt, backend="pallas", device=card)
    with pytest.raises(ValueError, match="float64"):
        pt.spgemm_csr(a, tm=16, backend="pallas",
                      compute_dtype=torch.float64, device=card)


def test_spmm_entry_points_on_card_match_cpu(card, monkeypatch):
    rng = np.random.default_rng(32)
    a = _matrix("integer", 3000, 64)
    t = pt.csr_to_tiles(a, 16, 128)
    x = rng.integers(-4, 5, (a.n, 100)).astype(np.float64)
    host = pt.spmm(t, x, device="cpu").numpy()
    import scipy.sparse as sp

    ref = sp.csr_matrix((a.data, a.indices, a.indptr), shape=a.shape) @ x
    assert np.array_equal(host, ref)
    w = spmm_kernels.spmm_strip
    assert pspmm._spmm_mode(t, 128, device=card)[0] == "resident"
    for l2 in (pspmm.L2_BYTES, 0):  # 0: X never fits, the window form runs
        monkeypatch.setattr(pspmm, "L2_BYTES", l2)
        before = w.kernel_launches
        y = pt.spmm(t, x, device=card)
        assert w.kernel_launches == before + 1
        assert y.device.type == "cuda" and torch.equal(y.cpu(),
                                                       torch.from_numpy(host))
    monkeypatch.undo()
    before = w.narrow_launches
    v = pt.spmv(t, x[:, 0], device=card)
    assert w.narrow_launches == before + 1
    assert v.shape == (a.m,) and np.array_equal(v.cpu().numpy(), host[:, 0])
    for backend in ("xla", "gather"):
        y = pt.spmm(t, x, backend=backend, device=card)
        assert np.array_equal(y.cpu().numpy(), host)
    y64 = pt.spmm(t, x + 0.25, dtype=torch.float64, device=card)
    h64 = pt.spmm(t, x + 0.25, dtype=torch.float64, device="cpu")
    assert y64.dtype == torch.float64
    torch.testing.assert_close(y64.cpu(), h64, rtol=1e-12, atol=1e-12)
    assert pspmm.time_spmm(t, x, warmup=1, iters=3, device=card) > 0
    assert pspmm.time_spmm_gather(a, x, warmup=1, iters=3, device=card) > 0


def test_pair_entry_points_on_card_match_cpu(card):
    a = cantlike(3000, 64)
    ref = golden.spgemm_scipy(a, a)
    w = pair_kernels.pair_accumulate_cuda
    for backend in ("pallas", "xla"):
        before = (w.kernel_launches, w.plain_launches)
        gc, res = pt.spgemm_csr(a, tm=64, tn=128, backend=backend,
                                device=card)
        assert res.stats["backend"] == backend
        assert (w.kernel_launches, w.plain_launches) == (
            before[0] + (backend == "pallas"), before[1])
        hc, _ = pt.spgemm_csr(a, tm=64, tn=128, backend=backend,
                              device="cpu")
        assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)
        got = golden.drop_explicit_zeros(gc)
        assert got.pattern_equal(ref) and np.array_equal(got.data, ref.data)
    ag = a.with_data(np.random.default_rng(4).standard_normal(a.nnz))
    gc, _ = pt.spgemm_csr(ag, backend="xla", compute_dtype=torch.float64,
                          device=card)
    refg = golden.spgemm_scipy(ag, ag)
    got = golden.drop_explicit_zeros(gc)
    assert got.pattern_equal(refg)
    np.testing.assert_allclose(got.data, refg.data, rtol=1e-12,
                               atol=1e-12 * np.abs(refg.data).max())
    empty = pt.CSR.from_coo([], [], np.zeros(0), (300, 300))
    res = pt.spgemm(pt.csr_to_tiles(empty, 16, 128),
                    pt.csr_to_tiles(empty, 128, 128), backend="pallas",
                    device=card)
    assert res.c.nnz == 0 and res.stats["numblkC"] == 0


def test_cli_pair_backends_on_card(card, tmp_path, capsys):
    from spgemm_tpu_torch.cli import main

    p = tmp_path / "p.mtx"
    _write_mtx(p, cantlike(2000, 64))
    for backend in ("pallas", "xla"):
        assert main(["-d", "cuda:0", str(p), "64", "128", "--backend",
                     backend]) == 0
        out = capsys.readouterr().out
        assert "check (values vs scipy oracle): [PASSED]" in out


def _route_pair(values: str, n: int = 1500, band: int = 48):
    a = cantlike(n, band)
    if values == "gaussian":
        a = a.with_data(np.random.default_rng(4).standard_normal(a.nnz))
    return a


def _assert_csr_close(got, exp, values):
    assert got.pattern_equal(exp)
    if values == "integer":
        np.testing.assert_array_equal(got.data, exp.data)
    else:
        scale = np.abs(exp.data).max()
        np.testing.assert_allclose(got.data, exp.data, rtol=1e-5,
                                   atol=1e-6 * scale)


@pytest.mark.parametrize("backend", ["gustavson", "dense", "auto"])
@pytest.mark.parametrize("tiles", [(16, 16), (8, 16), (16, 128)])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_torch_op_routes_on_card_match_cpu(card, backend, tiles, values):
    a = _route_pair(values)
    at, bt = pt.csr_to_tiles(a, *tiles), pt.csr_to_tiles(a, tiles[1],
                                                        tiles[1])
    res = pt.spgemm(at, bt, backend=backend, device=card)
    if backend == "auto":
        assert res.stats["backend"] == (
            "strip" if tiles == (16, 128) else "dense")
    else:
        assert res.stats["backend"] == backend
    exp = pt.spgemm(at, bt, backend=backend, device="cpu").c.to_csr()
    _assert_csr_close(res.c.to_csr(), exp, values)


@pytest.mark.parametrize("backend", ["gustavson", "dense"])
def test_torch_op_routes_f64_on_card(card, backend):
    a = _route_pair("gaussian", 800)
    at = pt.csr_to_tiles(a, 16, 16)
    res = pt.spgemm(at, at, backend=backend, compute_dtype=torch.float64,
                    device=card)
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(res.c.to_csr())
    assert got.pattern_equal(ref)
    assert np.abs(got.data - ref.data).max() <= \
        1e-13 * np.abs(ref.data).max()


@pytest.mark.parametrize("kind", ["integer", "gaussian", "wide-int"])
@pytest.mark.parametrize("tiles", [(16, 16), (8, 16), (64, 128)])
def test_slab_engine_bit_equal_to_cpu(card, kind, tiles):
    rng = np.random.default_rng(6)
    a = cantlike(1200, 40)
    vals = {"integer": lambda: rng.integers(1, 10, a.nnz).astype(float),
            "gaussian": lambda: rng.standard_normal(a.nnz),
            "wide-int": lambda: rng.integers(-2 ** 20, 2 ** 20,
                                             a.nnz).astype(float)}[kind]()
    a = a.with_data(vals)
    at, bt = pt.csr_to_tiles(a, *tiles), pt.csr_to_tiles(a, tiles[1],
                                                        tiles[1])
    plan = build_ozaki_plan(at, bt)
    host = ozaki_core(*plan.to_device("cpu"), **plan.core_kwargs())
    dev = ozaki_core(*plan.to_device(card), **plan.core_kwargs())
    for h, d in zip(host, dev):
        assert torch.equal(h, d.cpu())


def test_ozaki_executor_on_card(card):
    a = _route_pair("gaussian", 1200)
    at = pt.csr_to_tiles(a, 16, 16)
    plan = pt.build_ozaki_plan(at, at)
    ex = pt.OzakiExecutor(plan, at, at, device=card)
    host = pt.OzakiExecutor(pt.build_ozaki_plan(at, at), at, at,
                            device="cpu")
    np.testing.assert_array_equal(ex.assemble(ex.run()),
                                  host.assemble(host.run()))
    a2 = a.with_data(np.random.default_rng(9).standard_normal(a.nnz))
    at2 = pt.csr_to_tiles(a2, 16, 16)
    ex.update_values(at2, at2)
    host.update_values(at2, at2)
    np.testing.assert_array_equal(ex.assemble(ex.run()),
                                  host.assemble(host.run()))
    assert ex.time_numeric(warmup=1, iters=3) > 0


@pytest.mark.parametrize("api", ["legacy", "fp32_precision"])
def test_tf32_switched_on_globally_is_not_used(card, api):
    """A caller's global TF32 switch must not reach the gustavson, dense,
    slab and xla products (the JAX package multiplies at HIGHEST), and
    must be back on after the call."""
    a = _route_pair("gaussian", 1200, 64)
    at = pt.csr_to_tiles(a, 16, 16)
    exp = {b: pt.spgemm(at, at, backend=b, device="cpu").c.to_csr()
           for b in ("gustavson", "dense", "xla")}
    mm = torch.backends.cuda.matmul
    prev = mm.fp32_precision
    try:
        if api == "legacy":
            mm.allow_tf32 = True
        else:
            mm.fp32_precision = "tf32"
        # the switch is live: a bare f32 matmul rounds its operands
        x = torch.randn(512, 512, device=card)
        tf32_err = (x @ x - (x.double() @ x.double()).float()).abs().max()
        assert tf32_err.item() > 1e-3
        for backend, ref in exp.items():
            res = pt.spgemm(at, at, backend=backend, device=card)
            _assert_csr_close(res.c.to_csr(), ref, "gaussian")
        # the slab engine's f32 slice products stay exact too
        plan = build_ozaki_plan(at, at)
        host = ozaki_core(*plan.to_device("cpu"), **plan.core_kwargs())
        dev = ozaki_core(*plan.to_device(card), **plan.core_kwargs())
        assert all(torch.equal(h, d.cpu()) for h, d in zip(host, dev))
        if api == "legacy":
            assert mm.allow_tf32 is True
        else:
            assert mm.fp32_precision == "tf32"
    finally:
        mm.fp32_precision = prev


def test_slab_engine_tk_gate_on_card(card):
    """tk > 1040 past the f32 products' exact range: on CUDA there is no
    Ozaki kernel for these tiles, the slab engine refuses the plan with
    OzakiOverflow, and the auto f64 router runs the double-double scan."""
    rng = np.random.default_rng(1)
    a = pt.CSR.from_coo(rng.integers(0, 1100, 3000),
                        rng.integers(0, 1100, 3000),
                        rng.standard_normal(3000), (1100, 1100))
    at, bt = pt.csr_to_tiles(a, 16, 1056), pt.csr_to_tiles(a, 1056, 1056)
    with pytest.raises(OzakiOverflow, match="tk <= 1040"):
        pt.spgemm(at, bt, backend="ozaki", device=card)
    got, res = pt.spgemm_csr(a, tm=16, tn=1056, compute_dtype=torch.float64,
                             device=card)
    assert res.stats["backend"] == "esc"
    ref = golden.spgemm_scipy(a, a)
    got = golden.drop_explicit_zeros(got)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-10,
                               atol=1e-11 * np.abs(ref.data).max())


@pytest.mark.parametrize("backend", ["gustavson", "dense"])
def test_cli_fallback_routes_on_card(card, tmp_path, capsys, backend):
    from spgemm_tpu_torch.cli import main

    a = cantlike(2000, 64)
    p = tmp_path / "c.mtx"
    _write_mtx(p, a)
    assert main(["-d", "cuda:0", str(p), "16", "16", "--backend",
                 backend]) == 0
    out = capsys.readouterr().out
    assert "check (values vs scipy oracle): [PASSED]" in out


def long_positive_sums(k=4096, n=256, density=0.3, seed=21):
    """A (n x k) times B (k x n), positive uniform values at `density`:
    each C entry sums ~k*density^2 (about 370) products spread over k/8
    mma steps."""
    rng = np.random.default_rng(seed)
    mk = lambda m_, n_: pt.CSR.from_dense(
        rng.random((m_, n_)) * (rng.random((m_, n_)) < density))
    return mk(n, k), mk(k, n)


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
def test_strip_kernel_long_positive_sums(card, tm):
    """Long sums of positive products stay within rtol 1e-5, atol
    1e-6*max|C| of the f64 sum, as a sequential f32 sum does: the mma
    aligns its addends by truncation, so the 3xTF32 products go into a
    fresh partial sum each k8 step and reach the accumulator by an
    ordinary add (accumulating them in place biased such sums downward
    by ~1e-5)."""
    a, b = long_positive_sums()
    res = pt.spgemm(pt.csr_to_tiles(a, tm, 128), pt.csr_to_tiles(b, 128, 128),
                    backend="strip", device=card)
    assert res.stats["backend"] == "strip"
    got = golden.drop_explicit_zeros(res.c.to_csr())
    ref = golden.spgemm_scipy(a, b)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5,
                               atol=1e-6 * np.abs(ref.data).max())


@pytest.mark.parametrize("tm", [8, 16, 32, 64])
def test_pair_kernel_long_positive_sums(card, tm):
    """The pair kernel (backend="pallas") on the same long positive sums:
    32 (A tile, B tile) pairs per C tile, 512 k8 steps per entry, within
    rtol 1e-5, atol 1e-6*max|C| of the f64 sum (the kernel now adds each
    step's exact split products into a fresh partial sum, as the strip
    kernel does)."""
    a, b = long_positive_sums()
    w = pair_kernels.pair_accumulate_cuda
    before = w.kernel_launches
    res = pt.spgemm(pt.csr_to_tiles(a, tm, 128), pt.csr_to_tiles(b, 128, 128),
                    backend="pallas", device=card)
    assert w.kernel_launches == before + 1
    got = golden.drop_explicit_zeros(res.c.to_csr())
    ref = golden.spgemm_scipy(a, b)
    assert got.pattern_equal(ref)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5,
                               atol=1e-6 * np.abs(ref.data).max())


@pytest.mark.parametrize("k_pad,form", [(128, "resident"), (256, "window")])
def test_spmm_kernel_long_positive_sums(card, k_pad, form):
    """SpMM's 128-column form on long rows of positive products: A (256 x
    4096) at 30% (about 1,230 products per Y entry) times a positive
    uniform X, resident at k 128 and windowed at k 256, within rtol 1e-5,
    atol 1e-6*max|Y| of the f64 product."""
    a, _ = long_positive_sums()
    rng = np.random.default_rng(22)
    x = rng.random((a.n, k_pad))
    t = pt.csr_to_tiles(a, 16, 128)
    block_rows = 8
    ops = pspmm._pack_spmm_operands(t, x, k_pad, torch.float32,
                                    block_rows).to_device(card)
    kmin = None
    if form == "window":
        stats = pspmm._spmm_block_stats(t, block_rows)
        kmin = torch.from_numpy(pspmm._window_kmin(t, stats)).to(card)
    w = spmm_kernels.spmm_strip
    before = (w.kernel_launches, w.narrow_launches)
    y = w(*ops, kmin, gm=t.gm, block_rows=block_rows)
    assert (w.kernel_launches, w.narrow_launches) == (before[0] + 1,
                                                      before[1])
    got = y.reshape(-1, k_pad)[: a.m].double().cpu().numpy()
    f32 = lambda v: v.astype(np.float32).astype(np.float64)
    ref = f32(a.to_dense()) @ f32(x)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


# --- the ESC digit mode (torch ops, no hand kernel) -----------------------------

@pytest.mark.parametrize("values", ["integer", "gaussian", "f64"])
def test_digit_mode_matches_cpu(card, values):
    """The one-hot contraction on the card against the CPU: its output is
    identical whether the groups run in one chunk or in many (each
    group's sum is independent of the chunking); C equals the CPU's
    exactly on integer values, within rtol 1e-6 on Gaussian f32 values
    (bmm sums in another order) and rtol 1e-12 in f64."""
    from spgemm_tpu_torch.ops import esc as pesc

    rng = np.random.default_rng(12)
    a = random_uniform(rng, 3000, 24)
    if values != "integer":
        a = a.with_data(rng.standard_normal(a.nnz))
    dtype = torch.float64 if values == "f64" else torch.float32
    plan = pt.build_esc_plan(a, a)
    ops = plan.to_device(card, dtype)
    whole = pesc.esc_numeric(plan, ops)
    per_group = max(c["w"] for c in plan.classes) * 96 * 9
    chunked = pesc.esc_numeric(plan, ops, budget_bytes=3 * per_group)
    assert all(torch.equal(x, y) for x, y in zip(whole, chunked))
    assert (pesc.esc_trim(plan, whole).data
            == pesc.esc_trim(plan, chunked).data).all()
    _zero_all_counters()
    got, _, _ = pt.spgemm_esc(a, a, mode="digit", dtype=dtype, device=card)
    exp, _, _ = pt.spgemm_esc(a, a, mode="digit", dtype=dtype, device="cpu")
    assert not _any_kernel_ran()
    assert got.pattern_equal(exp)
    if values == "integer":
        np.testing.assert_array_equal(got.data, exp.data)
    else:
        rtol = 1e-12 if values == "f64" else 1e-6
        np.testing.assert_allclose(got.data, exp.data, rtol=rtol,
                                   atol=rtol * np.abs(exp.data).max())


def _wrappers():
    return (kernels.strip_numeric, scan_kernels.esc_scan,
            scan_kernels.esc_scan_mul, scan_kernels.esc_scan_dd,
            ozaki_kernels.ozaki_strip_numeric, spmm_kernels.spmm_strip,
            pair_kernels.pair_accumulate_cuda,
            gather_kernels.take_along_blocks)


def _zero_all_counters():
    for w in _wrappers():
        w.kernel_launches = w.plain_launches = 0
    spmm_kernels.spmm_strip.narrow_launches = 0


def _any_kernel_ran():
    return any(w.kernel_launches or w.plain_launches for w in _wrappers())


# --- the example applications at their small sizes ------------------------------

@pytest.mark.parametrize("name,argv", [
    ("triangle_counting", []),
    ("amg_galerkin", ["32", "2"]),
    ("markov_clustering", ["512"]),
    ("pagerank", ["2048", "8"]),
    ("power_method", ["4096", "8"]),
    ("serving_loop", ["512", "1"]),
])
def test_example_on_card(card, name, argv, capsys):
    import importlib

    mod = importlib.import_module(f"spgemm_tpu_torch.examples.{name}")
    _zero_all_counters()
    assert mod.main(argv + ["--device", "cuda"]) == 0
    out = capsys.readouterr().out
    assert "MISMATCH" not in out
    # no plain kernel version ran on the card
    assert all(w.plain_launches == 0 for w in _wrappers())
    if name == "power_method":
        assert spmm_kernels.spmm_strip.narrow_launches == 150
    if name == "serving_loop":
        assert kernels.strip_numeric.kernel_launches >= 1
        assert scan_kernels.esc_scan.kernel_launches >= 1


def test_entry_on_card(card):
    from spgemm_tpu_torch.entry import entry

    fn, args = entry()
    assert all(t.device.type == "cuda" for t in args)
    fn_c, args_c = entry(device="cpu")
    for got, exp in zip(fn(*args), fn_c(*args_c)):
        assert torch.equal(got.cpu(), exp)


# --- the multi-device layer on one card --------------------------------------

@pytest.mark.parametrize("form", ["pairs", "gustavson", "ring", "strip",
                                  "esc", "ozaki"])
def test_dist_formulations_one_rank_on_card(card, form):
    """Each formulation on the one-rank mesh of a process with no group
    (make_mesh(), device None: card 0) equals the same formulation on the
    CPU; the strip and ESC shards launch their kernels, and no plain
    version runs on the card."""
    from spgemm_tpu_torch.parallel import dist as pdist

    a = _matrix("integer", 1500, 48)
    mesh = pdist.make_mesh()
    assert mesh.device == torch.device("cuda", 0) and mesh.group is None
    cpu = pdist.make_mesh(device="cpu")
    t16 = pt.csr_to_tiles(a, 16, 16)
    tw, bw = pt.csr_to_tiles(a, 16, 128), pt.csr_to_tiles(a, 128, 128)
    run = {"pairs": lambda m: pdist.spgemm_sharded_pairs(t16, t16, m),
           "gustavson": lambda m: pdist.spgemm_sharded(t16, t16, m),
           "ring": lambda m: pdist.spgemm_sharded_ring(t16, t16, m),
           "strip": lambda m: pdist.spgemm_sharded_strip(tw, bw, m,
                                                         block_rows=4),
           "esc": lambda m: pdist.spgemm_sharded_esc(a, a, m),
           "ozaki": lambda m: pdist.spgemm_sharded_ozaki(tw, bw, m)}[form]
    _zero_all_counters()
    got = run(mesh)
    assert all(w.plain_launches == 0 for w in _wrappers())
    if form == "strip":
        assert kernels.strip_numeric.kernel_launches == 1
    if form == "esc":
        assert scan_kernels.esc_scan.kernel_launches == 1
    exp = run(cpu)
    if form != "esc":
        got, exp = got.to_csr(), exp.to_csr()
    assert got == exp


# --- the fuzz cases and the tools on the card --------------------------------

@pytest.mark.parametrize("case", FUZZ_CASES,
                         ids=[f"c{c[-1]}" for c in FUZZ_CASES])
@pytest.mark.parametrize("backend", ["strip", "gustavson", "dense", "xla",
                                     "auto"])
def test_fuzz_on_card(card, case, backend, record_property):
    """tests/test_torch_fuzz.py's cases on the card against scipy (rtol
    1e-5, atol 1e-8 on integer values). The router sends these odd tiles
    from strip and auto to dense or gustavson (no hand kernel, no plain
    version); each route is recorded. None of these tiles is one the
    strip kernel is built for (tn 128)."""
    a, b = fuzz_operands(case)
    tm, tn = case[4], case[5]
    _zero_all_counters()
    res = pt.spgemm(pt.csr_to_tiles(a, tm, tn), pt.csr_to_tiles(b, tn, tn),
                    backend=backend, device=card)
    route = str(res.stats["backend"])
    record_property("route", route)
    assert all(w.kernel_launches == 0 and w.plain_launches == 0
               for w in _wrappers())
    if backend in ("strip", "auto"):
        assert route.split("(")[0] in ("dense", "gustavson"), route
    else:
        assert route.split("(")[0] == backend, route
    got = golden.drop_explicit_zeros(res.c.to_csr())
    ref = golden.spgemm_scipy(a, b)
    assert got.pattern_equal(ref), route
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5, atol=1e-8)


def test_tool_timers_on_card(card):
    """time_ozaki_strip, time_esc_scan_dd and device_ms_esc_scan_dd return
    positive milliseconds, launching their kernels."""
    from spgemm_tpu_torch.ops.esc import (build_esc_scan_plan,
                                          device_ms_esc_scan_dd,
                                          time_esc_scan_dd)
    from spgemm_tpu_torch.ops.ozaki import time_ozaki_strip

    a = _matrix("gaussian", 2000, 48)
    plan = build_ozaki_strip(pt.csr_to_tiles(a, 32, 128),
                             pt.csr_to_tiles(a, 128, 128))
    _zero_all_counters()
    assert time_ozaki_strip(plan, warmup=1, iters=3) > 0
    assert ozaki_kernels.ozaki_strip_numeric.kernel_launches == 4
    r = random_uniform(np.random.default_rng(7), 4096)
    sp = build_esc_scan_plan(r, r)
    assert time_esc_scan_dd(sp, r.data, r.data, warmup=1, iters=3) > 0
    assert device_ms_esc_scan_dd(sp, r.data, r.data, iters=3) > 0
    assert scan_kernels.esc_scan_dd.kernel_launches == 4 + 4
    assert all(w.plain_launches == 0 for w in _wrappers())


def test_bench_small_on_card(card):
    """`python -m spgemm_tpu_torch.bench` at BENCH_ROWS=3000 prints one
    JSON line with every key of the root bench.py."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.run([sys.executable, "-m", "spgemm_tpu_torch.bench"],
                       cwd=root, capture_output=True, text=True, timeout=600,
                       env={**os.environ, "BENCH_ROWS": "3000"})
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "e2e_ms", "sol_ms",
                "sol_pct", "f64_gflops", "f64_vs_baseline", "f64_int_gflops"):
        assert key in line, key
    assert line["metric"] == "spgemm_cantlike_gflops" and line["value"] > 0
    assert 0 < line["sol_pct"] <= 100


# --- tile shapes beyond the kernels' instantiated heights -----------------
#
# Every kernel of a tiled route takes the tiles its TPU kernel takes: tm %
# 8 == 0 and tn % 128 == 0, cut into chunks of the instantiated heights
# (strip and pair: 64/32/16/8 rows x 128 columns; SpMM: sub-tiles of
# 64/32/16/8 rows; Ozaki: 32/16/8 rows x 64 columns).

CHUNKED_TILES = [(24, 128), (128, 128), (8, 256), (40, 384), (48, 256)]


@pytest.mark.parametrize("tm,tn", CHUNKED_TILES)
@pytest.mark.parametrize("window", [None, False])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_strip_kernel_chunked_tiles_match_plain(card, tm, tn, window,
                                                values):
    a = _matrix(values, 2500, 64)
    args = build_strip_args(pt.csr_to_tiles(a, tm, tn),
                            pt.csr_to_tiles(a, tn, tn), window=window)
    ops = args.to_device(card)
    w = kernels.strip_numeric
    before = (w.kernel_launches, w.plain_launches)
    kv, kc = w(*ops, **args.kernel_kwargs())
    pv, pc = kernels.strip_numeric_plain(*ops, **args.kernel_kwargs())
    torch.cuda.synchronize()
    assert (w.kernel_launches, w.plain_launches) == (before[0] + 1,
                                                     before[1])
    assert kv.shape[1:] == (tm, tn)
    _assert_close(kv, pv, values)
    assert torch.equal(kc, pc)


@pytest.mark.parametrize("tm,tn", CHUNKED_TILES)
@pytest.mark.parametrize("tk", [7, 128])
def test_pair_kernel_chunked_tiles_match_plain(card, tm, tn, tk):
    for values in ("integer", "gaussian"):
        a = _matrix(values, 900 if tk < 16 else 1500, 64)
        at, bt = pt.csr_to_tiles(a, tm, tk), pt.csr_to_tiles(a, tk, tn)
        sched = build_pair_schedule(at, bt)
        ops = _pair_ops(at, bt, sched, card, torch.bfloat16)
        w = pair_kernels.pair_accumulate_cuda
        before = (w.kernel_launches, w.plain_launches)
        gv, gc = w(*ops, num_segments=sched.nt_c)
        pv, pc = pair_kernels.pair_accumulate_plain(*ops,
                                                    num_segments=sched.nt_c)
        torch.cuda.synchronize()
        assert (w.kernel_launches, w.plain_launches) == (before[0] + 1,
                                                         before[1])
        _assert_close(gv, pv, values)
        assert torch.equal(gc, pc)


@pytest.mark.parametrize("tm,tn", [(8, 128), (64, 128), (24, 256),
                                   (128, 128)])
@pytest.mark.parametrize("case,sizes,pmax", [
    ("integer", (1, 1), None), ("gaussian", (8, 8), None),
    ("gaussian", (8, 8), 14), ("gaussian-x-wide-int", (8, 3), None)])
def test_ozaki_kernel_chunked_tiles_match_plain(card, tm, tn, case, sizes,
                                                pmax):
    rng = np.random.default_rng(23)
    a = banded(rng, 1500, 64)
    x = y = a
    if case != "integer":
        x = a.with_data(rng.standard_normal(a.nnz))
        y = x if case == "gaussian" else a.with_data(
            rng.integers(-2 ** 20, 2 ** 20, a.nnz).astype(np.float64))
    plan = build_ozaki_strip(pt.csr_to_tiles(x, tm, tn),
                             pt.csr_to_tiles(y, tn, tn))
    assert (plan.sa, plan.sb) == sizes
    ops = plan.to_device(card)
    kw = plan.kernel_kwargs()
    if pmax is not None:
        kw["pmax"] = pmax
    w = ozaki_kernels.ozaki_strip_numeric
    before = (w.kernel_launches, w.plain_launches)
    got = w(*ops, **kw)
    exp = ozaki_kernels.ozaki_strip_numeric_plain(*ops, **kw)
    torch.cuda.synchronize()
    assert (w.kernel_launches, w.plain_launches) == (before[0] + 1,
                                                     before[1])
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.mark.parametrize("tm", [8, 16, 24, 32, 64])
@pytest.mark.parametrize("tn", [128, 256])
@pytest.mark.parametrize("pmax", [None, 4, 14])
def test_ozaki_wgmma_tiles_bit_equal(card, tm, tn, pmax):
    """The wgmma kernel at every chunk height it runs (32, 16, 8 and their
    sums), one and two 128-column items, up to 8 pair groups (the plan's
    pmax 7, and 4: truncated) and all 15: (h, m, l, cnt) bit-equal to the
    plain version, Gaussian values, S = 8x8."""
    rng = np.random.default_rng(25)
    a = banded(rng, 1200, 64)
    a = a.with_data(rng.standard_normal(a.nnz))
    plan = build_ozaki_strip(pt.csr_to_tiles(a, tm, 128),
                             pt.csr_to_tiles(a, 128, tn))
    assert (plan.sa, plan.sb) == (8, 8)
    got = _ozaki_check(card, plan, pmax)
    assert bool((got[3] > 0).any())


@pytest.mark.parametrize("tm", [24, 40, 128, 256])
@pytest.mark.parametrize("width,k", [(8, 1), (32, 20), (128, 100),
                                     (256, 256)])
def test_spmm_kernel_chunked_tiles_match_plain(card, tm, width, k):
    rng = np.random.default_rng(36)
    for values in ("integer", "gaussian"):
        a = _spmm_matrix(values)
        t = pt.csr_to_tiles(a, tm, 128)
        x = (rng.integers(-4, 5, (a.n, k)).astype(np.float64)
             if values == "integer" else rng.standard_normal((a.n, k)))
        block_rows = 3
        stats = pspmm._spmm_block_stats(t, block_rows)
        packed = pspmm._pack_spmm_operands(t, x, width, torch.float32,
                                           block_rows)
        ops, smap = packed.to_device(card), packed.sector_map_to(card)
        kmin = torch.from_numpy(pspmm._window_kmin(t, stats)).to(card)
        w = spmm_kernels.spmm_strip
        for form in (None, kmin):
            before = (w.kernel_launches, w.narrow_launches, w.plain_launches)
            got = w(*ops, form, gm=t.gm, block_rows=block_rows, smap=smap)
            exp = spmm_kernels.spmm_strip_plain(*ops, form, gm=t.gm,
                                                block_rows=block_rows)
            torch.cuda.synchronize()
            assert (w.kernel_launches, w.narrow_launches,
                    w.plain_launches) == (before[0] + 1,
                                          before[1] + (width <= 32),
                                          before[2])
            assert got.shape == exp.shape == (t.gm + (-t.gm) % block_rows,
                                              tm, width)
            _assert_close(got, exp, values)
            assert not got[t.gm:].any()


@pytest.mark.parametrize("tm,tn", [(128, 128), (40, 256)])
def test_chunked_strip_and_pair_long_positive_sums(card, tm, tn):
    """The strip and pair kernels at chunked tiles on the long positive
    sums that found the in-place 3xTF32 bias: within rtol 1e-5, atol
    1e-6*max|C| of the f64 sum."""
    a, b = long_positive_sums()
    ref = golden.spgemm_scipy(a, b)
    for backend, w in (("strip", kernels.strip_numeric),
                       ("pallas", pair_kernels.pair_accumulate_cuda)):
        before = w.kernel_launches
        res = pt.spgemm(pt.csr_to_tiles(a, tm, tn),
                        pt.csr_to_tiles(b, tn, tn), backend=backend,
                        device=card)
        assert w.kernel_launches == before + 1
        got = golden.drop_explicit_zeros(res.c.to_csr())
        assert got.pattern_equal(ref)
        np.testing.assert_allclose(got.data, ref.data, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref.data).max())


@pytest.mark.parametrize("tm", [24, 128])
def test_chunked_spmm_long_positive_sums(card, tm):
    a, _ = long_positive_sums()
    x = np.random.default_rng(22).random((a.n, 128))
    t = pt.csr_to_tiles(a, tm, 128)
    ops = pspmm._pack_spmm_operands(t, x, 128, torch.float32,
                                    8).to_device(card)
    y = spmm_kernels.spmm_strip(*ops, gm=t.gm, block_rows=8)
    got = y.reshape(-1, 128)[: a.m].double().cpu().numpy()
    f32 = lambda v: v.astype(np.float32).astype(np.float64)
    ref = f32(a.to_dense()) @ f32(x)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def test_kernels_raise_outside_their_tiles(card):
    """A tile outside a kernel's gate raises on CUDA, and no plain version
    runs in its place."""
    a = _matrix("integer", 400, 8)
    _zero_all_counters()
    for tm, tn in ((12, 128), (16, 64), (16, 200)):
        args = build_strip_args(pt.csr_to_tiles(a, tm, tn),
                                pt.csr_to_tiles(a, tn, tn))
        with pytest.raises(ValueError, match="strip kernel takes"):
            kernels.strip_numeric(*args.to_device(card),
                                  **args.kernel_kwargs())
        at, bt = pt.csr_to_tiles(a, tm, tn), pt.csr_to_tiles(a, tn, tn)
        sched = build_pair_schedule(at, bt)
        with pytest.raises(ValueError, match="pair kernel takes"):
            pair_kernels.pair_accumulate_cuda(
                *_pair_ops(at, bt, sched, card, torch.bfloat16),
                num_segments=sched.nt_c)
        plan = build_ozaki_strip(at, bt)
        with pytest.raises(ValueError, match="Ozaki strip kernel takes"):
            ozaki_kernels.ozaki_strip_numeric(*plan.to_device(card),
                                              **plan.kernel_kwargs())
    t = pt.csr_to_tiles(a, 12, 128)
    ops = pspmm._pack_spmm_operands(t, np.ones((a.n, 4)), 128,
                                    torch.float32, 4).to_device(card)
    with pytest.raises(ValueError, match="SpMM kernel takes"):
        spmm_kernels.spmm_strip(*ops, gm=t.gm, block_rows=4)
    assert not _any_kernel_ran()


@pytest.mark.parametrize("tm,tn", [(128, 128), (40, 256), (24, 128)])
def test_chunked_entry_points_route_to_the_kernels(card, tm, tn):
    """spgemm_csr at aligned tiles takes the strip kernel on the card (and
    backend="pallas" the pair kernel), f64 the Ozaki kernel, spmm the SpMM
    kernel: C equal to the CPU's."""
    a = cantlike(3000, 64)
    for backend, w, name in (
            ("auto", kernels.strip_numeric, "strip"),
            ("pallas", pair_kernels.pair_accumulate_cuda, "pallas")):
        before = w.kernel_launches
        got, res = pt.spgemm_csr(a, tm=tm, tn=tn, backend=backend,
                                 device=card)
        assert res.stats["backend"] == name
        assert w.kernel_launches == before + 1
        exp, _ = pt.spgemm_csr(a, tm=tm, tn=tn, backend=backend,
                               device="cpu")
        assert got.pattern_equal(exp) and np.array_equal(got.data, exp.data)
    ag = a.with_data(np.random.default_rng(0).standard_normal(a.nnz))
    w = ozaki_kernels.ozaki_strip_numeric
    before = w.kernel_launches
    gc, res = pt.spgemm_csr(ag, tm=tm, tn=tn, compute_dtype=torch.float64,
                            device=card)
    assert res.stats["backend"] == "ozaki-strip(S=8x8)"
    assert w.kernel_launches == before + res.stats["ozaki_passes"] == \
        before + 4
    hc, _ = pt.spgemm_csr(ag, tm=tm, tn=tn, compute_dtype=torch.float64,
                          device="cpu")
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)
    t = pt.csr_to_tiles(a, tm, tn)
    x = np.random.default_rng(1).integers(-4, 5, (a.n, 64)).astype(float)
    w = spmm_kernels.spmm_strip
    before = w.kernel_launches
    y = pt.spmm(t, x, backend="strip", device=card)
    assert w.kernel_launches == before + 1
    assert torch.equal(y.cpu(), pt.spmm(t, x, backend="strip",
                                        device="cpu"))


def test_cli_reports_the_strip_route_at_128x256(card, tmp_path, capsys):
    """`python -m spgemm_tpu_torch A.mtx 128 256` runs the strip kernel on
    the card and says so on stderr."""
    from spgemm_tpu_torch.cli import main

    a = cantlike(2000, 64)
    p = tmp_path / "c.mtx"
    rows = a.rows_expanded() + 1
    with open(p, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{a.m} {a.n} {a.nnz}\n")
        for r, c, v in zip(rows, a.indices + 1, a.data):
            f.write(f"{r} {c} {v:.17g}\n")
    before = kernels.strip_numeric.kernel_launches
    assert main(["-d", "cuda:0", str(p), "128", "256"]) == 0
    out = capsys.readouterr()
    assert "check (values vs scipy oracle): [PASSED]" in out.out
    assert "route: strip" in out.err
    assert kernels.strip_numeric.kernel_launches == before + 1


# --- the dynamic-gather probe's kernel ----------------------------------------

@pytest.mark.parametrize("name,shape,axis,blk,idx_max", GATHER_CASES,
                         ids=[c[0] for c in GATHER_CASES])
def test_gather_kernel_matches_plain(card, name, shape, axis, blk, idx_max):
    x, idx = case_inputs(shape, idx_max)
    xd, idd = torch.from_numpy(x).to(card), torch.from_numpy(idx).to(card)
    w = gather_kernels.take_along_blocks
    before = (w.kernel_launches, w.plain_launches)
    got = w(xd, idd, axis=axis, blk_rows=blk)
    assert (w.kernel_launches, w.plain_launches) == (before[0] + 1,
                                                     before[1])
    exp = gather_kernels.take_along_blocks_plain(xd, idd, axis=axis,
                                                 blk_rows=blk)
    torch.cuda.synchronize()
    assert torch.equal(got, exp), name


def test_gather_kernel_refuses_and_never_falls_back(card):
    """Shapes past the kernel's limits raise on CUDA and no plain version
    runs in their place; an index outside the contract writes NaN and
    reads nothing outside the block."""
    w = gather_kernels.take_along_blocks
    _zero_all_counters()
    for shape, axis, blk in (((64, 2048), 1, 16), ((4096, 128), 0, 2048)):
        x = torch.zeros(shape, device=card)
        idx = torch.zeros(shape, dtype=torch.int32, device=card)
        with pytest.raises(ValueError, match="gather kernel takes"):
            w(x, idx, axis=axis, blk_rows=blk)
    with pytest.raises(ValueError, match="must divide"):
        w(torch.zeros(96, 128, device=card),
          torch.zeros(96, 128, dtype=torch.int32, device=card), axis=0,
          blk_rows=64)
    assert w.kernel_launches == w.plain_launches == 0
    assert not _any_kernel_ran()
    for axis, bad in ((1, 128), (0, 8), (1, -1)):
        idx = torch.zeros(64, 128, dtype=torch.int32, device=card)
        idx[5, 7] = bad
        out = w(torch.ones(64, 128, device=card), idx, axis=axis, blk_rows=8)
        torch.cuda.synchronize()
        assert torch.isnan(out[5, 7]) and int(torch.isnan(out).sum()) == 1


def test_chained_timer_and_l2_flush_on_card(card):
    from spgemm_tpu_torch.utils.timing import chained_device_ms, cuda_event_ms

    x = torch.rand(1 << 20, device=card)

    def chain(v):
        acc = torch.zeros((), device=card)
        for _ in range(4):
            acc = acc + (v + acc * 1e-30).sum()
        return acc

    assert 0 < chained_device_ms(chain, x, loop=4) < 1e3
    assert 0 < chained_device_ms(chain, x, loop=4, flush_l2=True) < 1e3
    assert 0 < cuda_event_ms(lambda: x.sum(), iters=5, flush_l2=True) < 1e3


def test_ozaki_passes_on_card_bit_equal_to_cpu(card):
    """top3d's SIMP stiffness (perfbench/matrices/top3d.py) at 24x8x4
    elements in 64x128 tiles: the auto f64 route runs its four hi/lo
    passes on the card, one kernel launch each and the combine on the
    card, and gives the CPU plain version's C bit for bit, within 1e-12
    of the plain reference entry by entry (|C - C_ref| / (|A||A|)_ij)."""
    from perfbench import reference
    from perfbench.matrices.top3d import Stiffness

    k = Stiffness({"nelx": 24, "nely": 8, "nelz": 4, "nu": 0.3,
                   "penal": 3.0, "E0": 1.0, "Emin": 1e-9})
    g = torch.Generator().manual_seed(2**31 + 11)
    a = pt.CSR(k.indptr, k.indices, k.values(g, torch.float64).numpy(),
               k.shape)
    w = ozaki_kernels.ozaki_strip_numeric
    before = (w.kernel_launches, w.plain_launches)
    gc, res = pt.spgemm_csr(a, tm=64, tn=128, compute_dtype=torch.float64,
                            device=card)
    assert res.stats["backend"] == "ozaki-strip(S=8x8)"
    assert res.stats["ozaki_passes"] == 4
    assert (w.kernel_launches, w.plain_launches) == (before[0] + 4,
                                                     before[1])
    hc, hres = pt.spgemm_csr(a, tm=64, tn=128, compute_dtype=torch.float64,
                             device="cpu")
    assert gc.pattern_equal(hc) and np.array_equal(gc.data, hc.data)
    assert res.stats["d2h_bytes"] == hres.stats["d2h_bytes"] <= \
        16 * res.stats["numblkC_candidate"] * 64 * 128
    ip, idx, val, mag = reference.spgemm(
        a.indptr, a.indices, a.data, a.indptr, a.indices, a.data, a.n,
        device=card)
    assert np.array_equal(ip.cpu().numpy(), gc.indptr)
    assert np.array_equal(idx.cpu().numpy(), gc.indices)
    err = np.abs(gc.data - val.cpu().numpy()) / mag.cpu().numpy()
    assert err.max() <= 1e-12, err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_picked_tilemat_on_card_equals_cpu(card, dtype):
    """top3d's SIMP stiffness at 24x8x4 elements in 64x128 tiles through
    spgemm_csr: float32 takes the strip route, float64 the four Ozaki
    passes. C's entries are picked on the card (pick_tiles.device_calls
    moves) and only C's arrays come down (d2h_bytes: keep flags, rc and
    values, the kept tiles' mask words and row pointers). The route's
    own planes, picked on the card, picked on the CPU and assembled on
    the host by _compact_to_tilemat, give one TileMat, bit for bit; so
    does the CPU's whole call in float64 (the passes are bit-equal), and
    in float32 its structure (the strip kernel's split rounds otherwise
    than the plain version)."""
    from perfbench.matrices.top3d import Stiffness
    from spgemm_tpu_torch.models.tile import csr_to_tiles
    from spgemm_tpu_torch.ops import gustavson as gu
    from spgemm_tpu_torch.ops.ozaki import ozaki_strip_passes_numeric
    from spgemm_tpu_torch.ops.spgemm import _compact_to_tilemat

    f32 = dtype == torch.float32
    k = Stiffness({"nelx": 24, "nely": 8, "nelz": 4, "nu": 0.3,
                   "penal": 3.0, "E0": 1.0, "Emin": 1e-9})
    g = torch.Generator().manual_seed(2**31 + 13)
    a = pt.CSR(k.indptr, k.indices, k.values(g, dtype).numpy(), k.shape)
    calls = gu.pick_tiles.device_calls
    _, res = pt.spgemm_csr(a, tm=64, tn=128, compute_dtype=dtype,
                           device=card)
    assert gu.pick_tiles.device_calls == calls + 1
    assert res.stats["backend"] == ("strip" if f32 else "ozaki-strip(S=8x8)")
    _, hres = pt.spgemm_csr(a, tm=64, tn=128, compute_dtype=dtype,
                            device="cpu")
    c, hc = res.c, hres.c
    nt_c = int(res.stats["numblkC_candidate"])
    picked = (nt_c + c.nnz * (4 + (4 if f32 else 8)) + c.nt * 64 * 4 * 4
              + c.nt * 65 * 4)
    assert res.stats["d2h_bytes"] == hres.stats["d2h_bytes"] == picked
    if f32:
        for f in TILE_FIELDS:
            if f != "val":
                assert np.array_equal(getattr(c, f), getattr(hc, f)), f
        np.testing.assert_allclose(c.val, hc.val, rtol=1e-5,
                                   atol=1e-6 * np.abs(hc.val).max())
    else:
        _assert_same(c, hc)

    at, bt = csr_to_tiles(a, 64, 128), csr_to_tiles(a, 128, 128)
    if f32:
        s = build_strip_args(at, bt)
        cv, cc = kernels.strip_numeric(*s.to_device(card),
                                       **s.kernel_kwargs())
        gidx = torch.from_numpy(s.gather_idx.astype(np.int64)).to(card)
        v, occ = gu.strip_compact(cv, cc, gidx)
    else:
        plan = build_ozaki_strip(at, bt, strict=True)
        s = plan.sargs
        (v, occ), _ = ozaki_strip_passes_numeric(plan, device=card)
    where = (s.ctrow, s.ctcol, (a.m, a.n))
    on_card = gu.pick_tiles(v, occ).tilemat(*where)
    v, occ = v.cpu(), occ.cpu()
    on_cpu = gu.pick_tiles(v, occ).tilemat(*where)
    host = _compact_to_tilemat(
        *where[:2], v.numpy(),
        gu.unpack_occ_words(occ.numpy(), 128) if f32 else occ.numpy(),
        where[2], 64, 128)
    _assert_same(on_card, on_cpu)
    _assert_same(on_card, host)
    _assert_same(on_card, c)
