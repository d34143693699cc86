"""The 128-column SpMM kernel's row-group walk, emulated in NumPy on the
CPU (`csrc/spmm_strip.cu:spmm_strip_kernel` runs only on the card).

The kernel gives one CTA a group of R = 128/tm consecutive tile rows. One
warp merges the rows' ak lists: the next slab is the least next ak over
the rows, each row whose next tile sits on that slab takes it, and up to
kSchedCap slabs are merged per pass. The CTA stages each merged slab once
and every row multiplies its tile against it. The emulation here follows
that walk on the packed plan of `ops/spmm.py` and checks what the kernel
relies on: every (tile row, tile) of the plan is visited exactly once,
each row's tiles in ascending ak, groups may span block edges and the
last group may be short, and the window form's slab kmin[blk] + (ak -
kmin[blk]) is slab ak. Its Y, summed in the walk's order, equals the
plain version `spmm_strip_plain` (exactly on integer values), which
tests/test_torch_spmm.py holds against the JAX package's Pallas kernels.
"""

import numpy as np
import pytest
import torch

import spgemm_tpu_torch as pt
import spgemm_tpu_torch.ops.spmm as pspmm
from spgemm_tpu_torch.ops import spmm_kernels

GROUP_ROWS = 128   # Y rows per CTA (kGroupRows)
SCHED_CAP = 64     # slabs merged per pass (kSchedCap)
INT_MAX = 2 ** 31 - 1


def group_walk(aptr, ak, *, gm, n_rows, tm, cap=SCHED_CAP):
    """[(group, [(slab, [tile or -1 per row])...])...] as the kernel
    merges it, passes concatenated."""
    r_per = GROUP_ROWS // tm
    out = []
    for row0 in range(0, n_rows, r_per):
        rows = [row0 + r for r in range(r_per)]
        cur = [int(aptr[i]) if i < gm else 0 for i in rows]
        end = [int(aptr[i + 1]) if i < gm else 0 for i in rows]
        entries = []
        while True:  # one pass: up to `cap` slabs
            sched = []
            while len(sched) < cap:
                mine = [int(ak[c]) if c < e else INT_MAX
                        for c, e in zip(cur, end)]
                v = min(mine)
                if v == INT_MAX:
                    break
                sched.append((v, [c if m == v else -1
                                  for c, m in zip(cur, mine)]))
                cur = [c + (m == v) for c, m in zip(cur, mine)]
            if not sched:
                break
            entries += sched
        out.append((row0, entries))
    return out


def walk_y(ops, kmin, *, gm, block_rows, tm, cap=SCHED_CAP):
    """Y by the walk, and the (row, tile) visits in order."""
    a_dense, xb, aptr, ak = (t.numpy() for t in ops[:4])
    k_pad = xb.shape[2]
    n_blocks = max(1, -(-gm // block_rows))
    n_rows = n_blocks * block_rows
    y = np.zeros((n_rows, tm, k_pad), np.float32)
    visits = []
    for row0, entries in group_walk(aptr, ak, gm=gm, n_rows=n_rows, tm=tm,
                                    cap=cap):
        for v, tiles in entries:
            for r, g in enumerate(tiles):
                if g < 0:
                    continue
                row = row0 + r
                slab = v
                if kmin is not None:  # the window form's rebased index
                    klo = int(kmin[row // block_rows])
                    slab = klo + (v - klo)
                assert slab == int(ak[g])
                visits.append((row, g))
                y[row] += a_dense[g] @ xb[slab]
    return y, visits


def _matrix(kind, rng):
    if kind == "banded_gaps":
        # a band with empty row ranges: empty tile rows and whole groups
        r = np.repeat(np.arange(900), 21)
        c = r + np.tile(np.arange(-10, 11), 900)
        keep = (c >= 0) & (c < 900) & (rng.random(r.size) < 0.6)
        keep &= (r < 200) | (r >= 420)
        keep &= (r < 640) | (r >= 650)
        return pt.CSR.from_coo(r[keep], c[keep],
                               rng.integers(1, 10, keep.sum()).astype(
                                   np.float64), (900, 900))
    # ragged: rows of 0 to 39 scattered nonzeros, and every third run of
    # 64 rows empty (empty tile rows at every tile height)
    n = 700
    counts = rng.integers(0, 40, n) * (rng.random(n) < 0.8)
    counts[np.arange(n) // 64 % 3 == 1] = 0
    r = np.repeat(np.arange(n), counts)
    c = rng.integers(0, 1100, r.size)
    return pt.CSR.from_coo(r, c, rng.integers(1, 10, r.size).astype(
        np.float64), (n, 1100))


@pytest.mark.parametrize("kind", ["banded_gaps", "ragged"])
@pytest.mark.parametrize("tm", [8, 16, 32, 64])
@pytest.mark.parametrize("block_rows,cap", [(6, SCHED_CAP), (8, 2)])
def test_walk_visits_every_tile_once_in_ascending_ak(kind, tm, block_rows,
                                                     cap):
    rng = np.random.default_rng(tm + block_rows)
    a = _matrix(kind, rng)
    t = pt.csr_to_tiles(a, tm, 16)
    x = rng.integers(-4, 5, (a.n, 130)).astype(np.float64)
    ops = pspmm._pack_spmm_operands(t, x, 256, torch.float32,
                                    block_rows).to_device("cpu")
    stats = pspmm._spmm_block_stats(t, block_rows)
    kmin = pspmm._window_kmin(t, stats)
    for km in (None, kmin):
        y, visits = walk_y(ops, km, gm=t.gm, block_rows=block_rows, tm=tm,
                           cap=cap)
        # every real (row, tile) once; rows past gm and padding tiles never
        exp = [(int(t.trow[g]), g) for g in range(t.nt)]
        assert sorted(visits) == sorted(exp)
        assert len(set(visits)) == len(visits)
        for row in range(t.gm):
            mine = [g for r, g in visits if r == row]
            cols = [int(t.tcol[g]) for g in mine]
            assert cols == sorted(cols) and mine == sorted(mine)
        plain = spmm_kernels.spmm_strip_plain(
            *ops, None if km is None else torch.from_numpy(km), gm=t.gm,
            block_rows=block_rows)
        np.testing.assert_array_equal(y, plain.numpy())
    # the shapes the kernel must handle show up here
    r_per = GROUP_ROWS // tm
    n_rows = plain.shape[0]
    if block_rows % r_per:
        assert any((g0 // block_rows) != ((g0 + r_per - 1) // block_rows)
                   for g0 in range(0, n_rows, r_per))  # a group spans blocks
    assert np.diff(t.tptr).min() == 0  # empty tile rows
    if n_rows % r_per:
        assert n_rows // r_per * r_per < n_rows  # a short last group


def test_walk_merges_slabs_shared_by_rows():
    # two tile rows of one group on the same slabs: each slab is staged
    # once (one schedule entry) for both rows
    aptr = np.array([0, 2, 4], np.int32)
    ak = np.array([3, 5, 3, 7], np.int32)
    (row0, entries), = group_walk(aptr, ak, gm=2, n_rows=2, tm=64)
    assert row0 == 0
    assert entries == [(3, [0, 2]), (5, [1, -1]), (7, [-1, 3])]
    # with a cap of 1 the passes give the same sequence
    (_, capped), = group_walk(aptr, ak, gm=2, n_rows=2, tm=64, cap=1)
    assert capped == entries
