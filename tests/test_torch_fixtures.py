"""The port's converter against the repository's 36x36 fixture families
(counterpart of tests/test_fixtures.py): the golden per-row bitmasks at
four tile shapes, TileMat.mask_words and TileMat.occ_from_mask equal to
the JAX package's on the same files, and a round trip plus a product
through the port's spgemm_csr on the CPU (rtol 1e-5: f32 sums of the
fixtures' uniform values against the f64 dense-row oracle)."""

import glob
import os

import numpy as np
import pytest

from spgemm_tpu.io.mmio import read_mtx as j_read_mtx
from spgemm_tpu.models.tile import csr_to_tiles as j_csr_to_tiles
from spgemm_tpu_torch.io.mmio import read_mtx
from spgemm_tpu_torch.models.tile import csr_to_tiles, tiles_to_csr
from spgemm_tpu_torch.ops import golden
from spgemm_tpu_torch.ops.spgemm import spgemm_csr

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURES = sorted(glob.glob(os.path.join(FIXDIR, "*.mtx")))
TILES = [(16, 16), (12, 36), (36, 36), (16, 32)]


def test_fixtures_present():
    assert len(FIXTURES) == 7, FIXTURES


def _golden_bits(path, m, n):
    with open(path.replace(".mtx", ".bitmask")) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    words = np.array([[int(w, 16) for w in ln.split()] for ln in lines],
                     dtype=np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return ((words[:, :, None] >> shifts) & 1).reshape(m, -1)[:, :n]


@pytest.mark.parametrize("tm,tn", TILES)
def test_fixture_masks_against_golden(tm, tn):
    for path in FIXTURES:
        csr, _ = read_mtx(path)
        t = csr_to_tiles(csr, tm, tn)
        occ = t.occ()
        got = np.zeros((t.gm * t.tm, t.gn * t.tn), dtype=np.uint8)
        for i in range(t.nt):
            r0, c0 = t.trow[i] * tm, t.tcol[i] * tn
            got[r0: r0 + tm, c0: c0 + tn] |= occ[i]
        np.testing.assert_array_equal(got[: csr.m, : csr.n],
                                      _golden_bits(path, csr.m, csr.n),
                                      err_msg=path)


@pytest.mark.parametrize("tm,tn", TILES)
def test_mask_words_and_occ_from_mask_equal_jax(tm, tn):
    for path in FIXTURES:
        t = csr_to_tiles(read_mtx(path)[0], tm, tn)
        jt = j_csr_to_tiles(j_read_mtx(path)[0], tm, tn)
        assert t.mask_words == jt.mask_words == -(-tn // 32)
        np.testing.assert_array_equal(t.mask, jt.mask, err_msg=path)
        got = t.occ_from_mask()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jt.occ_from_mask(), err_msg=path)
        np.testing.assert_array_equal(got, t.occ(), err_msg=path)


def test_fixture_roundtrip_and_spgemm():
    for path in FIXTURES:
        csr, _ = read_mtx(path)
        assert csr.allclose(tiles_to_csr(csr_to_tiles(csr, 16, 16)))
        c, _ = spgemm_csr(csr, tm=12, tn=36, device="cpu")
        ref = golden.spgemm_dense_row(csr, csr)
        assert c.pattern_equal(ref), path
        np.testing.assert_allclose(c.data, ref.data, rtol=1e-5)
