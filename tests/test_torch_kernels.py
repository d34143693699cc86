"""The port's strip kernel module against the JAX Pallas strip kernel
(interpret mode on the CPU): same plan, same block-padded output.

The wrapper runs the plain PyTorch version on CPU tensors; the CUDA
kernel itself is checked against that plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: integer values are exact in f32, so they must agree exactly;
Gaussian values are summed in another order by the two versions, so
rtol 1e-5 and atol 1e-6*max|C| (a TF32 product would miss this by ~1e-3).
Counts are compared only as > 0, as the pipeline reads them.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgemm_tpu.models.tile as jtile
from spgemm_tpu.ops.gustavson import build_strip_args as j_build_strip_args
from spgemm_tpu.ops.gustavson import strip_compact_device
from spgemm_tpu.ops.gustavson import unpack_occ_words as j_unpack
from spgemm_tpu.ops.pallas_kernels import gustavson_strip_pallas
from spgemm_tpu.utils.generators import banded as j_banded

from spgemm_tpu_torch.ops import gustavson as pg
from spgemm_tpu_torch.ops import kernels
from test_torch_strip_arith import emulate_walk, strip_pairs


def _matrix(values: str, n: int, band: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    a = j_banded(rng, n, band)
    if values == "gaussian":
        a = a.with_data(rng.standard_normal(a.nnz))
    return a


def _jax_plan(a, tm, tn, block_rows, window):
    return j_build_strip_args(jtile.csr_to_tiles(a, tm, tn),
                              jtile.csr_to_tiles(a, tn, tn),
                              block_rows=block_rows, window=window)


def _port_plan(jp):
    return pg.StripArgs.from_numpy(
        {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)})


def _assert_close(got, exp, values):
    if values == "integer":
        np.testing.assert_array_equal(got, exp)
    else:
        scale = float(np.abs(exp).max())
        np.testing.assert_allclose(got, exp, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("tm,tn,n,band,block_rows", [
    (8, 16, 160, 12, 4), (16, 128, 520, 64, 8)])
@pytest.mark.parametrize("window", [None, False])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_plain_strip_matches_pallas(tm, tn, n, band, block_rows, window,
                                    values):
    a = _matrix(values, n, band)
    jp = _jax_plan(a, tm, tn, block_rows, window)
    assert (jp.kwin is None) == (window is False)
    jv, jc = gustavson_strip_pallas(*map(jnp.asarray, jp.device_args()),
                                    **jp.kernel_kwargs(), interpret=True)
    pp = _port_plan(jp)
    before = kernels.strip_numeric.plain_launches
    pv, pc = kernels.strip_numeric(*pp.to_device("cpu"), **pp.kernel_kwargs())
    assert kernels.strip_numeric.plain_launches == before + 1
    assert pv.shape == jv.shape and pc.shape == jc.shape
    g = pp.gather_idx
    _assert_close(pv.numpy()[g], np.asarray(jv)[g], values)
    np.testing.assert_array_equal(pc.numpy()[g] > 0,
                                  np.asarray(jc, np.float32)[g] > 0)
    # slots no pair reaches are zero in the port's output
    unused = np.ones(pv.shape[0], bool)
    unused[g] = False
    assert not pv.numpy()[unused].any() and not pc.numpy()[unused].any()


@pytest.mark.parametrize("tm,tn,n,band,block_rows,tk", [
    (16, 128, 520, 64, 8, None), (40, 128, 400, 48, 4, None),
    (64, 256, 700, 90, 4, None), (16, 128, 500, 30, 8, 48)])
@pytest.mark.parametrize("values", ["integer", "gaussian"])
def test_pipeline_walk_matches_plain_and_pallas(tm, tn, n, band, block_rows,
                                                tk, values):
    """csrc/tile_pipeline.cuh's walk for the strip kernel, emulated
    (tests/test_torch_strip_arith.py:emulate_walk): the persistent CTAs'
    items (slot, 128-column chunk, row chunk) in order, each slot's pairs
    by the ordered scan of its block's slot words, 32-deep stages (a
    ragged tail at tk 48), the per-stage TF32-exact flag and the
    transposed split product; against the plain version and the Pallas
    kernel in interpret mode, from the identical plan. Padded slots come
    out zero."""
    a = _matrix(values, n, band)
    tk = tk or tn
    jp = j_build_strip_args(jtile.csr_to_tiles(a, tm, tk),
                            jtile.csr_to_tiles(a, tk, tn),
                            block_rows=block_rows, window=None)
    jv, jc = gustavson_strip_pallas(*map(jnp.asarray, jp.device_args()),
                                    **jp.kernel_kwargs(), interpret=True)
    pp = _port_plan(jp)
    ops = pp.to_device("cpu")
    kw = pp.kernel_kwargs()
    n_slots = -(-kw["gm"] // kw["block_rows"]) * kw["max_cblock"]
    ev, ec, order = emulate_walk(ops[:4], n_slots, tn,
                                 strip_pairs(ops, **kw), sms=6)
    pv, pc = kernels.strip_numeric_plain(*ops, **kw)
    _assert_close(ev.numpy(), pv.numpy(), values)
    assert torch.equal(ec, pc)
    g = pp.gather_idx
    _assert_close(ev.numpy()[g], np.asarray(jv)[g], values)
    np.testing.assert_array_equal(ec.numpy()[g] > 0,
                                  np.asarray(jc, np.float32)[g] > 0)
    unused = np.ones(n_slots, bool)
    unused[g] = False
    assert unused.any()
    assert not ev.numpy()[unused].any() and not ec.numpy()[unused].any()
    parts, n_cc = kernels.chunk_grid(tm, tn)
    assert len(order) == n_slots * n_cc * sum(n for _, _, n in parts)


def test_compaction_matches_jax_including_sign_bit():
    rng = np.random.default_rng(1)
    n_slots, tm, tn = 7, 4, 64
    c_val = rng.standard_normal((n_slots, tm, tn)).astype(np.float32)
    c_cnt = (rng.random((n_slots, tm, tn)) < 0.5).astype(np.float32) * 3
    c_cnt[2, :, 31] = 1.0   # column 31: bit 31 of word 0, int32's sign bit
    c_cnt[2, 0, :] = 1.0    # a full row: word value -1
    c_cnt[4] = 0.0          # an empty tile
    gidx = np.array([2, 0, 4, 6], np.int64)
    jv, jw = strip_compact_device(jnp.asarray(c_val), jnp.asarray(c_cnt),
                                  jnp.asarray(gidx.astype(np.int32)))
    pv, pw = pg.strip_compact(torch.from_numpy(c_val),
                              torch.from_numpy(c_cnt), torch.from_numpy(gidx))
    assert pw.dtype == torch.int32
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pw.numpy(), np.asarray(jw))
    assert (pw.numpy()[0, :, 0] < 0).all()
    np.testing.assert_array_equal(pg.unpack_occ_words(pw.numpy(), tn),
                                  j_unpack(np.asarray(jw), tn))
    np.testing.assert_array_equal(pg.unpack_occ_words(pw.numpy(), tn),
                                  c_cnt[gidx] > 0)


def test_wrapper_rejects_bad_operands():
    a = _matrix("integer", 64, 6)
    pp = _port_plan(_jax_plan(a, 8, 16, 4, None))
    ops = list(pp.to_device("cpu"))
    ops[1] = ops[1].float()  # occupancy must be bfloat16
    with pytest.raises(ValueError, match="a_occ"):
        kernels.strip_numeric(*ops, **pp.kernel_kwargs())
    with pytest.raises(ValueError, match="inconsistent"):
        kernels.strip_numeric(*pp.to_device("cpu"),
                              **dict(pp.kernel_kwargs(), gm=pp.gm + 1))
