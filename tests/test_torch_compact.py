"""C's entries picked out of candidate-order tile planes where the planes
are (ops/gustavson.py:pick_tiles) against the host assembly that the
multi-device layer keeps (ops/spgemm.py:_compact_to_tilemat): the same
TileMat, field by field and bit for bit, on CPU tensors. The same torch
ops run on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from spgemm_tpu_torch.ops import gustavson
from spgemm_tpu_torch.ops.gustavson import pick_tiles, strip_compact
from spgemm_tpu_torch.ops.spgemm import _compact_to_tilemat

FIELDS = ("trow", "tcol", "tptr", "tnnz_ptr", "rc", "val", "mask", "rowptr")


def _planes(seed, nt_c, tm, tn, dtype, *, density=0.05, empty=(),
            zeros=0.0, gn=7):
    """Candidate-order planes of nt_c tiles: float32 counts (0 to 3) at
    `density`, values wherever a count is and noise where none is (the
    picker must read occupancy, never values), `zeros` of the occupied
    slots holding a structural zero (value 0, count > 0), the tiles in
    `empty` with no count. ctrow/ctcol are sorted distinct tile keys."""
    rng = np.random.default_rng(seed)
    occ = rng.random((nt_c, tm, tn)) < density
    cnt = (occ * rng.integers(1, 4, occ.shape)).astype(np.float32)
    cnt[list(empty)] = 0
    occ = cnt > 0
    val = rng.standard_normal(occ.shape).astype(dtype)
    val[occ & (rng.random(occ.shape) < zeros)] = 0
    gm = max(1, -(-nt_c // gn) + 2)
    keys = np.sort(rng.choice(gm * gn, nt_c, replace=False))
    ctrow, ctcol = (keys // gn).astype(np.int32), (keys % gn).astype(np.int32)
    shape = (gm * tm - 3, gn * tn - 1)
    return val, cnt, ctrow, ctcol, shape


def _host(val, cnt, ctrow, ctcol, shape):
    tm, tn = val.shape[1:]
    return _compact_to_tilemat(ctrow, ctcol, val, cnt, shape, tm, tn)


def _assert_same(got, exp):
    assert (got.shape, got.tm, got.tn) == (exp.shape, exp.tm, exp.tn)
    for f in FIELDS:
        g, e = getattr(got, f), getattr(exp, f)
        assert g.dtype == e.dtype and g.shape == e.shape, f
        if f == "val":  # bit for bit
            g, e = g.view(np.int64), e.view(np.int64)
        assert np.array_equal(g, e), f


def _d2h(c, nt_c, itemsize):
    """The picker's download: keep flags, rc, values in the planes' dtype,
    the kept tiles' mask words and row pointers."""
    mw = -(-c.tn // 32)
    return (nt_c + c.nnz * (4 + itemsize) + c.nt * c.tm * mw * 4
            + c.nt * (c.tm + 1) * 4)


CASES = [
    # name, nt_c, tm, tn, dtype, keyword arguments of _planes
    ("64x128-f32", 6, 64, 128, np.float32, {}),
    ("64x128-f64", 6, 64, 128, np.float64, {}),
    ("8x128-f32", 9, 8, 128, np.float32, {}),
    ("8x128-f64", 9, 8, 128, np.float64, {}),
    ("16x16-bools", 11, 16, 16, np.float32, {"density": 0.2}),
    ("24x40-bools", 5, 24, 40, np.float64, {"density": 0.1}),
    ("structural-zeros", 7, 64, 128, np.float32, {"zeros": 0.5}),
    ("pruned-tiles", 8, 64, 128, np.float64, {"empty": (0, 3, 4, 7)}),
    ("no-candidates", 0, 64, 128, np.float32, {}),
    ("all-empty", 5, 64, 128, np.float32, {"empty": range(5)}),
]


@pytest.mark.parametrize("name,nt_c,tm,tn,dtype,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_picked_tilemat_equals_the_host_assembly(name, nt_c, tm, tn, dtype,
                                                 kw):
    val, cnt, ctrow, ctcol, shape = _planes(3, nt_c, tm, tn, dtype, **kw)
    timings, moved = {}, {}
    calls = gustavson.pick_tiles.host_calls
    got = pick_tiles(torch.from_numpy(val), torch.from_numpy(cnt), timings,
                     moved).tilemat(ctrow, ctcol, shape)
    exp = _host(val, cnt, ctrow, ctcol, shape)
    _assert_same(got, exp)
    assert gustavson.pick_tiles.host_calls == calls + 1
    assert moved["d2h_bytes"] == _d2h(exp, nt_c, val.itemsize)
    assert timings["download_ms"] >= 0.0
    if "zeros" in kw:
        assert (got.val == 0).sum() > 0
    if "empty" in kw:
        assert got.nt == int((cnt.reshape(nt_c, -1) > 0).any(1).sum())


@pytest.mark.parametrize("occ_dtype", [torch.bool, torch.float32,
                                       torch.float64])
def test_counts_and_bools_pick_alike(occ_dtype):
    """Occupancy as bools or as counts of any float dtype, read as > 0."""
    val, cnt, ctrow, ctcol, shape = _planes(5, 6, 16, 128, np.float32,
                                            zeros=0.3)
    occ = torch.from_numpy(cnt)
    occ = occ > 0 if occ_dtype == torch.bool else occ.to(occ_dtype)
    got = pick_tiles(torch.from_numpy(val), occ).tilemat(ctrow, ctcol, shape)
    _assert_same(got, _host(val, cnt, ctrow, ctcol, shape))


@pytest.mark.parametrize("tm,tn", [(64, 128), (8, 128), (16, 64), (8, 32)])
def test_strip_words_pick_as_the_bools(tm, tn):
    """The strip route hands over strip_compact's int32 words (bit 31 is
    the sign bit): the same TileMat as the bool input of the same planes,
    and the words are the TileMat's mask as they are."""
    val, cnt, ctrow, ctcol, shape = _planes(7, 8, tm, tn, np.float32,
                                            density=0.3, empty=(2,))
    cnt[:, :, 31::32] = 1  # every word's sign bit set somewhere
    cnt[2] = 0
    v, words = strip_compact(torch.from_numpy(val), torch.from_numpy(cnt),
                             torch.arange(8))
    moved_w, moved_b = {}, {}
    from_words = pick_tiles(v, words, moved=moved_w).tilemat(ctrow, ctcol,
                                                             shape)
    from_bools = pick_tiles(torch.from_numpy(val), torch.from_numpy(cnt) > 0,
                            moved=moved_b).tilemat(ctrow, ctcol, shape)
    _assert_same(from_words, from_bools)
    _assert_same(from_words, _host(val, cnt, ctrow, ctcol, shape))
    keep = (cnt.reshape(8, -1) > 0).any(1)
    assert np.array_equal(from_words.mask,
                          words.numpy()[keep].view(np.uint32))
    assert moved_w == moved_b
