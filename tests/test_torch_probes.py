"""The three hardware probes of the unstructured engine and the gather
kernel behind the first, held to the JAX repo's tools on the same seeded
inputs (CPU):

* take_along_blocks on CPU tensors (its plain version) bit-equal to the
  Pallas kernel of `tools/probe_dyngather.py:make_gather_kernel`, run
  under pltpu.force_tpu_interpret_mode() (the JAX file is unchanged);
* the reference's axis-0 check (`tools/probe_dyngather.py:52`) compares
  the kernel with the global take, which is another function once R >
  blk: the Pallas kernel differs from it and equals the blockwise take;
* the wrapper's refusals (R % blk_rows, indices outside the contract,
  dtypes) and the card kernel's limits;
* every row of the port's probe_sort and probe_primitives, at F = 4,096:
  the torch body against the jax.lax / jnp expression the reference
  inlines, on the same inputs. Sorted keys and payloads and gathers are
  equal, sums within f32 rtol 1e-6 (another summation order), the bf16
  matmul rows within rtol 1e-2 (bf16 operands, f32 sums in another
  order);
* the port's cases and row names are the reference's, read from its
  source.
"""

import ast
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from spgemm_tpu_torch.ops import gather_kernels as gk
from spgemm_tpu_torch.tools import probe_dyngather as pdg
from spgemm_tpu_torch.tools import probe_primitives as ppr
from spgemm_tpu_torch.tools import probe_sort as pso

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F_TEST = 4096


def _reference_tool(name):
    """The JAX repo's tools/<name>.py as a module (it imports jax)."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_calls(name, fn):
    """The literal arguments of every call of `fn` in tools/<name>.py."""
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        tree = ast.parse(f.read())
    return [[ast.literal_eval(a) for a in node.args
             if isinstance(a, (ast.Constant, ast.Tuple))]
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "id", None) == fn]


def _pallas_gather(shape, axis, blk, x, idx):
    ref = _reference_tool("probe_dyngather")
    with pltpu.force_tpu_interpret_mode():
        fn = jax.jit(ref.make_gather_kernel(shape, axis, blk))
        return np.asarray(fn(jnp.asarray(x), jnp.asarray(idx)))


def _inputs(shape, idx_max, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.integers(0, idx_max, shape).astype(np.int32))


@pytest.mark.parametrize("shape,axis,blk", [
    ((64, 128), 1, 16), ((64, 256), 1, 16), ((64, 128), 0, 8),
    ((64, 128), 0, 32), ((1024, 128), 0, 512)])
def test_take_along_blocks_equals_pallas_kernel(shape, axis, blk):
    x, idx = _inputs(shape, shape[1] if axis == 1 else blk, seed=sum(shape))
    want = _pallas_gather(shape, axis, blk, x, idx)
    before = (gk.take_along_blocks.kernel_launches,
              gk.take_along_blocks.plain_launches)
    got = pdg.make_gather_kernel(shape, axis, blk)(torch.from_numpy(x),
                                                   torch.from_numpy(idx))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), pdg.blockwise_take(x, idx, axis, blk))
    assert (gk.take_along_blocks.kernel_launches,
            gk.take_along_blocks.plain_launches) == (before[0],
                                                     before[1] + 1)


def test_reference_axis0_check_compares_the_global_take():
    shape, blk = (64, 128), 8
    x, idx = _inputs(shape, blk, seed=3)
    got = _pallas_gather(shape, 0, blk, x, idx)
    # what tools/probe_dyngather.py:52 compares against: another function
    assert not np.array_equal(got, np.take_along_axis(x, idx, axis=0))
    assert np.array_equal(got, pdg.blockwise_take(x, idx, 0, blk))


@pytest.mark.parametrize("case", ["rows", "axis1_hi", "axis0_hi", "negative",
                                  "dtype", "axis", "shape"])
def test_take_along_blocks_raises(case):
    x = torch.rand(64, 128)
    idx = torch.zeros(64, 128, dtype=torch.int32)
    kw = dict(axis=1, blk_rows=16)
    if case == "rows":
        kw["blk_rows"] = 48
    elif case == "axis1_hi":
        idx[5, 7] = 128
    elif case == "axis0_hi":
        kw = dict(axis=0, blk_rows=8)
        idx[5, 7] = 8
    elif case == "negative":
        idx[0, 0] = -1
    elif case == "dtype":
        idx = idx.long()
    elif case == "axis":
        kw["axis"] = 2
    else:
        idx = idx[:32]
    with pytest.raises(ValueError):
        gk.take_along_blocks(x, idx, **kw)


def test_gather_kernel_limits():
    assert gk.gather_kernel_takes((8192, 1024), axis=1, blk_rows=256)
    assert not gk.gather_kernel_takes((8192, 2048), axis=1, blk_rows=256)
    assert gk.gather_kernel_takes((8192, 4096), axis=0, blk_rows=1024)
    assert not gk.gather_kernel_takes((8192, 128), axis=0, blk_rows=2048)
    assert not gk.gather_kernel_takes((100, 128), axis=0, blk_rows=8)


def test_dyngather_cases_are_the_reference_nine():
    ref = [tuple(a) for a in _reference_calls("probe_dyngather", "try_case")
           if len(a) == 5]
    ported = [(n, tuple(s), ax, b, m) for n, s, ax, b, m in pdg.CASES]
    assert ported == ref and len(ref) == 9
    assert pdg.LOOP == _reference_tool("probe_dyngather").LOOP


def test_probe_row_names_are_the_reference_rows():
    sort_rows = [a[0] for a in _reference_calls("probe_sort", "report")]
    assert list(pso.ROWS) == sort_rows
    prim = [a[0] for a in _reference_calls("probe_primitives", "report")]
    assert list(ppr.PROBES) == prim
    ref = _reference_tool("probe_primitives")
    assert (ppr.F, ppr.TAB, ppr.ROWS, ppr.RW, ppr.LOOP) == (
        ref.F, ref.TAB, ref.ROWS, ref.RW, ref.LOOP)
    assert (pso.F, pso.LOOP) == (_reference_tool("probe_sort").F,
                                 _reference_tool("probe_sort").LOOP)


# --- the rows' bodies against the reference's inline expressions ------------

def _jdep(acc):
    return (acc > jnp.float32(1e30)).astype(jnp.int32)


# probe_sort.py:60-131, the expression each row times (before its sum)
JAX_SORT_ROWS = {
    "sort int32 (real dep)": lambda acc, k: jax.lax.sort(k + _jdep(acc)),
    "sort_key_val int32/f32 (real dep)":
        lambda acc, k, v: jax.lax.sort_key_val(k + _jdep(acc), v),
    "sort key + 2 payloads":
        lambda acc, k, v: jax.lax.sort((k + _jdep(acc), v, v * 2.0),
                                       num_keys=1),
    "sort int32 1M (real dep)": lambda acc, k: jax.lax.sort(k + _jdep(acc)),
    "batched sort 4096x2048 axis=1":
        lambda acc, k: jax.lax.sort(k + _jdep(acc), dimension=1),
    "cumsum f32 (recheck)": lambda acc, v: jnp.cumsum(v + acc * 1e-30),
    "element gather small table 16K":
        lambda acc, t, ix: jnp.take(t + acc * 1e-30, ix),
    "take_along_axis rows of 2048":
        lambda acc, v, ix: jnp.take_along_axis(v + acc * 1e-30, ix, axis=1),
    "row gather 8-wide":
        lambda acc, t, ix: jnp.take(t + acc * 1e-30, ix, axis=0),
}


def _jax_masked(acc, p, s):
    w = p.shape[1]
    oid = jax.lax.broadcasted_iota(jnp.int32, (1, w, 128), 2)
    mask = (s[:, :, None] == oid).astype(jnp.bfloat16)
    outs = jax.lax.dot_general(
        (p + acc * 1e-30).astype(jnp.bfloat16)[:, None, :], mask,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    return outs[:, 0]


def _jax_onehot(acc, v, ix):
    bw = v.shape[1]
    src = jax.lax.broadcasted_iota(jnp.int32, (1, bw, bw), 1)
    oh = (ix[:, None, :] == src).astype(jnp.bfloat16)
    res = jax.lax.dot_general(
        (v + acc * 1e-30).astype(jnp.bfloat16)[:, None, :], oh,
        dimension_numbers=(((2,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32)
    return res[:, 0]


def _jax_segsum(sorted_ids):
    def body(acc, v, s):
        return jax.ops.segment_sum(v + acc * 1e-30, s,
                                   num_segments=v.shape[0] // 2,
                                   indices_are_sorted=sorted_ids)
    return body


# probe_primitives.py:71-164
JAX_PRIMITIVE_ROWS = {
    "element gather (take)": lambda acc, t, ix: jnp.take(
        t + acc * 1e-30, ix, indices_are_sorted=False, unique_indices=False),
    "row gather (take axis=0, 128w)":
        lambda acc, t, ix: jnp.take(t + acc * 1e-30, ix, axis=0),
    "sort int32 keys":
        lambda acc, k: jax.lax.sort(k + acc.astype(jnp.int32) * 0),
    "sort_key_val int32/f32": lambda acc, k, v: jax.lax.sort_key_val(
        k + acc.astype(jnp.int32) * 0, v),
    "segment_sum sorted ids": _jax_segsum(True),
    "segment_sum unsorted ids": _jax_segsum(False),
    "cumsum f32": lambda acc, v: jnp.cumsum(v + acc * 1e-30),
    "masked-matmul seg reduce W=512": _jax_masked,
    "one-hot matmul gather BW=2048": _jax_onehot,
}


def _outputs(res):
    return res if isinstance(res, tuple) else (res,)


def _compare(got, want, name, rtol):
    got, want = _outputs(got), _outputs(want)
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if rtol is None:
            assert np.array_equal(g, w), name
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=name)


def _row_rtol(name):
    if "matmul" in name:
        return 1e-2
    if "cumsum" in name or "segment_sum" in name:
        return 1e-6
    return None


@pytest.mark.parametrize("name", list(pso.ROWS))
def test_probe_sort_row_equals_reference(name):
    op, reduce, args, _ = pso.ROWS[name]
    data = pso.make_inputs(F_TEST, args, "cpu")
    acc = torch.zeros((), dtype=torch.float32)
    got = op(acc, *[data[a] for a in args])
    want = JAX_SORT_ROWS[name](jnp.float32(0),
                               *[jnp.asarray(data[a].numpy()) for a in args])
    _compare(got, want, name, _row_rtol(name))
    scalar = reduce(got)
    assert scalar.dim() == 0 and torch.isfinite(scalar.float())
    # the chain adds LOOP such scalars, each call fed the last
    assert float(pso.chained(op, reduce, 2)(*[data[a] for a in args])) \
        == pytest.approx(2 * float(scalar.float()), rel=1e-6)


@pytest.mark.parametrize("name", list(ppr.PROBES))
def test_probe_primitives_row_equals_reference(name):
    op, reduce, args = ppr.PROBES[name]
    data = ppr.make_inputs(F_TEST, "cpu")
    acc = torch.zeros((), dtype=torch.float32)
    got = op(acc, *[data[a] for a in args])
    want = JAX_PRIMITIVE_ROWS[name](
        jnp.float32(0), *[jnp.asarray(data[a].numpy()) for a in args])
    _compare(got, want, name, _row_rtol(name))
    assert torch.isfinite(reduce(got).float())


def test_onehot_chunks_cover_every_group(monkeypatch):
    monkeypatch.setattr(ppr, "ONEHOT_BYTES", 3 * 64 * 64 * 2)
    rng = np.random.default_rng(5)
    v = torch.from_numpy(rng.random((7, 64), dtype=np.float32))
    ix = torch.from_numpy(rng.integers(0, 64, (7, 64), dtype=np.int32))
    got = ppr.onehot_gather(torch.zeros(()), v, ix)
    want = torch.take_along_dim(v.bfloat16().float(), ix.long(), dim=1)
    assert torch.equal(got, want)


def test_card_timers_raise_off_cuda():
    from spgemm_tpu_torch.utils import timing

    if torch.cuda.is_available():
        pytest.skip("the CPU-only refusal")
    with pytest.raises(RuntimeError):
        timing.chained_device_ms(lambda: torch.zeros(()), loop=2)
    with pytest.raises(RuntimeError):
        timing.cuda_event_ms(lambda: None, flush_l2=True)
