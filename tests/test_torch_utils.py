"""The port's host utilities against the JAX package's on the CPU: the
roofline accounting, the timers, the torch.profiler trace switch, the
CSR helpers the examples use, the package exports and the compile-check
entry point."""

import json
import os
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spgemm_tpu
from spgemm_tpu.utils import roofline as jroofline
from spgemm_tpu.utils import timing as jtiming

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.entry import entry
from spgemm_tpu_torch.utils import roofline, timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def to_port(a):
    return pt.CSR(a.indptr.copy(), a.indices.copy(), a.data.copy(), a.shape)


@pytest.mark.parametrize("occ", [True, False])
@pytest.mark.parametrize("attained", [None, 0.5, 7.0])
def test_numeric_step_roofline_matches_jax(occ, attained):
    h = roofline.ChipSpec.h100()
    jchip = jroofline.ChipSpec(h.name, h.peak_flops_f32, h.peak_hbm_bw)
    args = dict(num_pairs=5844, tm=64, tk=128, tn=128, nnz_cub=263626643,
                nt_c=3896, attained_ms=attained, with_occupancy_pass=occ)
    got = roofline.numeric_step_roofline(**args)
    exp = jroofline.numeric_step_roofline(chip=jchip, **args)
    assert vars(got) == vars(exp)
    assert got.summary() == exp.summary()
    # the H100 is the port's default chip
    assert vars(roofline.numeric_step_roofline(**args)) == vars(
        roofline.numeric_step_roofline(chip=h, **args))


def test_h100_bound():
    h = roofline.ChipSpec.h100()
    assert (h.peak_hbm_bw, h.peak_ops) == (3.35e12, {
        "tf32": 495e12, "bf16": 989e12, "int8": 1979e12, "f32": 67e12})
    bytes_ms, ops_ms, ms, by = h.bound(3.35e9, [(495e9, "tf32")])
    assert (bytes_ms, ops_ms, ms, by) == (1.0, 1.0, 1.0, "bytes")
    assert h.bound(0, [(67e9, "f32"), (989e9, "bf16")])[2:] == (
        2.0, "operations")


def test_step_timer_and_best_of():
    t, jt = timing.StepTimer(), jtiming.StepTimer()
    for timer in (t, jt):
        for _ in range(2):
            with timer.step("a"):
                pass
        with timer.step("b"):
            pass
    assert set(t.ms) == set(jt.ms) == {"a", "b"}
    assert t.total() == pytest.approx(sum(t.ms.values()))
    calls = []
    ms, res = timing.best_of(lambda: calls.append(1) or len(calls), 4)
    assert res == 4 and len(calls) == 4 and 0 <= ms < 1e3


def test_host_mem_calibration_keys():
    cal = timing.host_mem_calibration(size_mb=4)
    assert set(cal) == set(jtiming.host_mem_calibration(size_mb=4))
    assert all(v > 0 for v in cal.values())


def test_device_trace_off_by_default(monkeypatch, tmp_path):
    monkeypatch.delenv("SPGEMM_TPU_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    with timing.device_trace("x"):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


def test_device_trace_writes_a_chrome_trace(monkeypatch, tmp_path):
    out = tmp_path / "trace"
    monkeypatch.setenv("SPGEMM_TPU_TRACE", str(out))
    with timing.device_trace("spgemm-test"):
        torch.ones(64).cumsum(0)
    (name,) = os.listdir(out)
    assert name.startswith("spgemm-test-") and name.endswith(".json")
    with open(out / name) as f:
        trace = json.load(f)
    assert any(e.get("name") == "spgemm-test"
               for e in trace["traceEvents"])


def test_spgemm_strip_runs_inside_the_trace(monkeypatch, tmp_path,
                                            make_random_csr):
    monkeypatch.setenv("SPGEMM_TPU_TRACE", str(tmp_path))
    a = to_port(make_random_csr(200, 200, 0.05))
    c, res = pt.spgemm_csr(a, backend="strip", device="cpu")
    assert res.stats["backend"] == "strip"
    # one trace of the whole call (the inner spgemm's steps aside), the
    # strip numeric phase's span inside it
    (name,) = os.listdir(tmp_path)
    assert name.startswith("spgemm_csr-")
    with open(tmp_path / name) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"spgemm.spgemm_csr", "spgemm.numeric",
            "spgemm.download"} <= names


def test_csr_to_dense_and_sorted_dedup_match_jax():
    r = np.random.default_rng(3)
    rows = np.sort(r.integers(0, 20, 200))
    # columns unsorted within rows, with duplicates, as a Matrix Market
    # file may hold them before canonicalization
    cols, vals = r.integers(0, 30, 200), r.standard_normal(200)
    indptr = np.zeros(21, np.int32)
    np.cumsum(np.bincount(rows, minlength=20), out=indptr[1:])
    ja = spgemm_tpu.CSR(indptr, cols.astype(np.int32), vals, (20, 30))
    pa = to_port(ja)
    np.testing.assert_array_equal(pa.to_dense(), ja.to_dense())
    got, exp = pa.sorted_dedup(), ja.sorted_dedup()
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, f), getattr(exp, f))
    np.testing.assert_allclose(got.to_dense(), ja.to_dense(), rtol=1e-15)


def test_exports_match_the_jax_package():
    assert pt.__version__ == spgemm_tpu.__version__
    missing = [n for n in spgemm_tpu.__all__ if n not in pt.__all__]
    assert missing == []
    for name in pt.__all__:
        assert hasattr(pt, name), name


def test_entry_matches_jax_entry():
    jfn, jargs = runpy.run_path(os.path.join(REPO, "__graft_entry__.py"),
                                run_name="x")["entry"]()
    fn, args = entry(device="cpu")
    assert len(args) == len(jargs)
    for got, exp in zip(args, jargs):
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))
    for got, exp in zip(fn(*args), jfn(*jargs)):
        # integer values: every sum is exact in f32
        np.testing.assert_array_equal(got.numpy(), np.asarray(exp))


def test_entry_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
