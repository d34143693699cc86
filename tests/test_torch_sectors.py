"""The narrow SpMM form's sector map and its sector-skipping arithmetic on
the CPU (csrc/spmm_strip.cu:spmm_narrow_kernel reads A only in the 32-byte
sectors that hold a stored entry).

The map is checked against TileMat.occ() bit for bit. The kernel's
arithmetic is emulated in NumPy, step for step as the kernel walks it
(virtual rows of the sub-tile height, k chunks of 1024/h values, batches
of NB steps, a batch read densely when its X chunks hold a non-finite
value), and compared with spmm_strip_plain and with the JAX package's
Pallas SpMM kernel in interpret mode at the reference's 128-padded k.
Tolerances: integer values are exact in f32 and in the f64 emulation, so
they agree exactly; Gaussian values are summed in another order, rtol
1e-5 and atol 1e-6*max|Y|; inf and NaN must sit where the dense product
puts them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgemm_tpu.models.tile as jtile
import spgemm_tpu.ops.spmm as jspmm
from spgemm_tpu.models.csr import CSR as JCSR
from spgemm_tpu.ops.pallas_kernels import spmm_strip_pallas

import spgemm_tpu_torch as pt
import spgemm_tpu_torch.ops.spmm as pspmm
from spgemm_tpu_torch.ops import spmm_kernels
from spgemm_tpu_torch.utils.generators import banded


def _matrix(kind, rng, n=300):
    if kind == "banded":
        return banded(rng, n, 12)
    if kind == "random":
        r, c = rng.integers(0, n, 2000), rng.integers(0, n, 2000)
        return pt.CSR.from_coo(r, c, rng.integers(1, 9, r.size).astype(
            np.float64), (n, n))
    return pt.CSR.from_coo([], [], np.zeros(0), (n, n))


def _bits(smap, n_bits):
    return np.unpackbits(smap.view(np.uint8), axis=1,
                         bitorder="little")[:, :n_bits]


@pytest.mark.parametrize("kind", ["banded", "random", "empty"])
@pytest.mark.parametrize("tm", [8, 16, 64])
@pytest.mark.parametrize("tn", [128, 256])
def test_sector_map_matches_occupancy(kind, tm, tn):
    rng = np.random.default_rng(71)
    t = pt.csr_to_tiles(_matrix(kind, rng), tm, tn)
    tail = 5
    smap = pspmm.sector_map(t, t.nt + tail)
    words = spmm_kernels.map_words(tm, tn)
    assert smap.dtype == np.int32 and smap.shape == (t.nt + tail, words)
    assert words * 32 == tm * tn // 8         # 32 bytes a 16x128 tile
    want = t.occ().reshape(t.nt, tm, tn // 8, 8).any(-1).reshape(
        t.nt, tm * tn // 8)
    bits = _bits(smap, tm * tn // 8)
    np.testing.assert_array_equal(bits[:t.nt], want)
    assert not bits[t.nt:].any()             # the zero tail


def test_sector_map_ragged_width():
    """tn not a multiple of 8: the last sector is partial; words round
    up."""
    rng = np.random.default_rng(72)
    t = pt.csr_to_tiles(_matrix("random", rng, 200), 8, 20)
    smap = pspmm.sector_map(t, t.nt)
    assert smap.shape[1] == spmm_kernels.map_words(8, 20) == 1
    occ = np.zeros((t.nt, 8, 24), np.uint8)
    occ[:, :, :20] = t.occ()
    want = occ.reshape(t.nt, 8, 3, 8).any(-1).reshape(t.nt, -1)
    np.testing.assert_array_equal(_bits(smap, 24), want)


def test_packing_adds_the_map_only_at_narrow_widths():
    rng = np.random.default_rng(73)
    t = pt.csr_to_tiles(_matrix("banded", rng), 16, 128)
    x = np.ones((t.n, 1))
    for width in spmm_kernels.NARROW_WIDTHS:
        ops = pspmm._pack_spmm_operands(t, x, width, torch.float32, 4)
        np.testing.assert_array_equal(
            ops.smap, pspmm.sector_map(t, t.nt + ops.max_ablock))
        assert ops.sector_map_to("cpu").dtype == torch.int32
    ops = pspmm._pack_spmm_operands(t, x, 128, torch.float32, 4)
    assert ops.smap is None and ops.sector_map_to("cpu") is None


def _sub_height(tm):
    return next(h for h in (64, 32, 16, 8) if tm % h == 0)


def emulate_narrow(a_dense, xb, aptr, ak, smap, *, gm, block_rows,
                   dense_on_nonfinite=True):
    """csrc/spmm_strip.cu:spmm_narrow_kernel in NumPy (f64): per virtual
    row (sub-tile of height h), steps (tile, k chunk of KC = 1024/h), in
    batches of NB; a thread (r, q) multiplies its sector's 8 values only
    where the sector's bit is set, or every sector when the batch's X
    chunks hold a non-finite value. Returns Y (n_blocks*block_rows, tm,
    W)."""
    a_dense, xb = np.asarray(a_dense, np.float64), np.asarray(xb, np.float64)
    ntp, tm, tk = a_dense.shape
    w = xb.shape[2]
    h = _sub_height(tm)
    n_sub = tm // h
    kc = 8 * (128 // h)                  # a thread's sector per row
    nb = max(1, min(4, 12288 // (kc * w + kc // 2 + 1024)))
    nsec = -(-tk // 8)
    bits = _bits(np.ascontiguousarray(smap), tm * nsec).reshape(
        ntp, tm, nsec).astype(bool)
    n_rows = max(1, -(-gm // block_rows)) * block_rows
    y = np.zeros((n_rows * n_sub, h, w))
    a_sub = a_dense.reshape(ntp * n_sub, h, tk)
    for v in range(gm * n_sub):
        ti, sub = divmod(v, n_sub)
        g0 = int(aptr[ti])
        nch = -(-tk // kc)
        steps = (int(aptr[ti + 1]) - g0) * nch
        for s0 in range(0, steps, nb):
            batch = [(g0 + st // nch, (st % nch) * kc)
                     for st in range(s0, min(steps, s0 + nb))]
            bad = dense_on_nonfinite and any(not np.isfinite(
                xb[ak[g], k0:min(tk, k0 + kc)]).all() for g, k0 in batch)
            for g, k0 in batch:
                k1 = min(tk, k0 + kc)
                use = bits[g, sub * h:(sub + 1) * h, k0 // 8:-(-k1 // 8)]
                mask = np.repeat(use, 8, axis=1)[:, :k1 - k0] | bad
                a_blk = np.where(mask, a_sub[g * n_sub + sub, :, k0:k1], 0.)
                with np.errstate(invalid="ignore"):
                    prod = a_blk[:, :, None] * xb[ak[g], k0:k1][None]
                    prod = np.where(mask[:, :, None], prod, 0.)
                    y[v] += prod.sum(axis=1)
    return y.reshape(n_rows, tm, w)


def _case(kind, tm, values, seed, nonfinite=False):
    rng = np.random.default_rng(seed)
    n = 260
    d = (rng.random((n, n)) < 0.2) * rng.integers(1, 9, (n, n))
    if kind == "banded":
        d *= np.abs(np.subtract.outer(np.arange(n), np.arange(n))) < 20
    d[:, (np.arange(n) // 8) % 3 == 0] = 0      # empty sectors
    d[:tm] = rng.integers(1, 9, (tm, n))          # a dense tile row
    d = d.astype(np.float64)
    if values == "gaussian":
        d = np.where(d != 0, rng.standard_normal((n, n)), 0.)
    a = JCSR.from_coo(*np.nonzero(d), d[np.nonzero(d)], (n, n))
    x = (rng.integers(-4, 5, (n, 3)).astype(np.float64)
         if values == "integer" else rng.standard_normal((n, 3)))
    if nonfinite:
        x[9, 0] = np.inf          # sector 1: skipped in many rows
        x[100, 1] = -np.inf
        x[101, 1] = np.inf
        x[250, 2] = np.nan
    return a, x


@pytest.mark.parametrize("tm", [8, 16, 24, 64])
@pytest.mark.parametrize("kind", ["banded", "random"])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
@pytest.mark.parametrize("k", [1, 3])
def test_sector_skipping_matches_plain_and_pallas(tm, kind, values, k):
    """Finite X: the emulated sector-skipping sums equal the plain
    version's and the Pallas kernel's (exactly for integers), at SpMV's
    width 1 and at width 8."""
    a, x = _case(kind, tm, values, seed=74 + tm)
    x = x[:, :k]
    block_rows = 2
    p_t = pt.csr_to_tiles(pt.CSR(a.indptr, a.indices, a.data, a.shape),
                          tm, 128)
    width = spmm_kernels.pack_width(x.shape[1])
    ops = pspmm._pack_spmm_operands(p_t, x, width, torch.float32,
                                    block_rows)
    dev = ops.to_device("cpu")
    emu = emulate_narrow(*dev[:4], ops.smap, gm=p_t.gm,
                         block_rows=block_rows)
    plain = spmm_kernels.spmm_strip_plain(*dev, gm=p_t.gm,
                                          block_rows=block_rows).numpy()
    jt = jtile.csr_to_tiles(a, tm, 128)
    j_ops = jspmm._pack_spmm_operands(jt, x, 128, jnp.float32, block_rows)
    pallas = np.asarray(spmm_strip_pallas(
        *map(jnp.asarray, j_ops[:5]), gm=jt.gm, max_ablock=j_ops[5],
        block_rows=block_rows, interpret=True))
    assert emu.shape == plain.shape and emu.shape[2] == width
    # skipped sectors exist, and dense ones
    bits = _bits(ops.smap[:p_t.nt], tm * 16)
    assert bits.any() and not bits.all()
    for ref in (plain, pallas[:emu.shape[0]]):
        if values == "integer":
            np.testing.assert_array_equal(emu[..., :k], ref[..., :k])
        else:
            np.testing.assert_allclose(emu[..., :k], ref[..., :k], rtol=1e-5,
                                       atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("tm", [8, 16, 64])
def test_sector_skipping_propagates_nonfinite_x(tm):
    """inf and NaN in X: the emulated kernel puts NaN and inf where the
    plain version and the Pallas kernel put them (0*inf in a skipped
    sector is NaN in the dense product)."""
    a, x = _case("banded", tm, "gaussian", seed=80 + tm, nonfinite=True)
    block_rows = 2
    p_t = pt.csr_to_tiles(pt.CSR(a.indptr, a.indices, a.data, a.shape),
                          tm, 128)
    ops = pspmm._pack_spmm_operands(p_t, x, 8, torch.float32, block_rows)
    dev = ops.to_device("cpu")
    emu = emulate_narrow(*dev[:4], ops.smap, gm=p_t.gm,
                         block_rows=block_rows)[..., :3]
    plain = spmm_kernels.spmm_strip_plain(
        *dev, gm=p_t.gm, block_rows=block_rows).numpy()[..., :3]
    jt = jtile.csr_to_tiles(a, tm, 128)
    j_ops = jspmm._pack_spmm_operands(jt, x, 128, jnp.float32, block_rows)
    pallas = np.asarray(spmm_strip_pallas(
        *map(jnp.asarray, j_ops[:5]), gm=jt.gm, max_ablock=j_ops[5],
        block_rows=block_rows, interpret=True))[:emu.shape[0], :, :3]
    assert np.isnan(plain).any() and np.isinf(plain).any()
    # without the dense read, the skipped 0*inf would leave finite values
    bits = _bits(ops.smap[:p_t.nt], tm * 16)
    assert not bits.all()
    for ref in (plain, pallas):
        np.testing.assert_array_equal(np.isnan(emu), np.isnan(ref))
        np.testing.assert_array_equal(np.isposinf(emu), np.isposinf(ref))
        np.testing.assert_array_equal(np.isneginf(emu), np.isneginf(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(emu[fin], ref[fin], rtol=1e-5,
                                   atol=1e-6 * np.abs(ref[fin]).max())


def test_dense_read_is_needed_for_nonfinite_x():
    """The same emulation without the dense read of a non-finite batch
    drops the 0*inf and 0*NaN of skipped sectors and misses NaNs the dense
    product has: the rule is what keeps Y as the plain version gives it."""
    a, x = _case("banded", 16, "gaussian", seed=85, nonfinite=True)
    p_t = pt.csr_to_tiles(pt.CSR(a.indptr, a.indices, a.data, a.shape),
                          16, 128)
    ops = pspmm._pack_spmm_operands(p_t, x, 8, torch.float32, 2)
    dev = ops.to_device("cpu")
    plain = spmm_kernels.spmm_strip_plain(*dev, gm=p_t.gm,
                                          block_rows=2).numpy()
    kw = dict(gm=p_t.gm, block_rows=2)
    with_rule = emulate_narrow(*dev[:4], ops.smap, **kw)
    without = emulate_narrow(*dev[:4], ops.smap, dense_on_nonfinite=False,
                             **kw)
    np.testing.assert_array_equal(np.isnan(with_rule), np.isnan(plain))
    assert np.isnan(plain).sum() > np.isnan(without).sum()
