"""The port's spans on the CPU (utils/timing.py:span): what they add to a
timings dict, that they touch the profiler only while one records, the
`spgemm.*` labels one spgemm_csr call leaves in a torch.profiler trace,
the keys the strip and ESC routes fill, their byte counters, and
device_trace stepping aside under an active profiler."""

import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import spgemm_tpu_torch as pt
from spgemm_tpu_torch.cli import main as cli_main
from spgemm_tpu_torch.io.mmio import write_mtx
from spgemm_tpu_torch.utils import timing

# the top-level spans of one spgemm_csr call, per route; download is a
# child (of numeric on the strip route, of compact on the ESC route)
STRIP_TOP = {"route", "tile", "prep", "symbolic", "upload", "numeric",
             "compact", "result"}
ESC_TOP = {"route", "symbolic", "upload", "numeric", "compact", "result"}
PARENT = {"strip": "numeric", "esc": "compact"}


def _csr(n, density, seed):
    m = sp.random(n, n, density=density, random_state=seed, format="csr",
                  dtype=np.float64)
    m.sort_indices()
    return pt.CSR(m.indptr.astype(np.int32), m.indices.astype(np.int32),
                  m.data, m.shape)


def _call(route):
    """One spgemm_csr call on the CPU through `route` ("strip": 16x128
    tiles of a banded matrix, the strip kernel's plain version; "esc": a
    random pattern, which the auto router sends to the ESC route)."""
    if route == "strip":
        m = sp.diags([np.ones(300 - abs(k)) for k in range(-6, 7)],
                     list(range(-6, 7)), format="csr") * 1.0
        a = pt.CSR(m.indptr.astype(np.int32), m.indices.astype(np.int32),
                   m.data.astype(np.float64), m.shape)
        return a, pt.spgemm_csr(a, tm=16, tn=128, backend="strip",
                                device="cpu")
    a = _csr(400, 0.01, 3)
    return a, pt.spgemm_csr(a, device="cpu")


def test_span_adds_and_accumulates():
    into = {"numeric_ms": 1.0}
    with timing.span("route", into):
        pass
    first = into["route_ms"]
    with timing.span("route", into):
        sum(range(1000))
    with timing.span("numeric", into):
        pass
    assert set(into) == {"route_ms", "numeric_ms"}
    assert into["route_ms"] > first > 0.0
    assert into["numeric_ms"] > 1.0
    with timing.span("nothing"):      # no dict: nothing to add to
        pass
    with pytest.raises(ValueError):   # the time is added on the way out
        with timing.span("raised", into):
            raise ValueError
    assert into["raised_ms"] >= 0.0


def test_span_calls_record_function_only_under_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    into = {}
    with timing.span("route", into), timing.StepTimer().step("plan"):
        pass
    assert opened == [] and "route_ms" in into
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("route", into):
            pass
    assert opened == ["spgemm.route"]


def _trace_events(tmp_path, fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name", "").startswith("spgemm.")]


@pytest.mark.parametrize("route", ["strip", "esc"])
def test_one_call_labels_its_spans_inside_the_root(tmp_path, route):
    _call(route)  # first use: native builds and imports out of the trace
    (_, (_, res)), spans = _trace_events(tmp_path, lambda: _call(route))
    assert res.stats["backend"] == route
    (root,) = [e for e in spans if e["name"] == "spgemm.spgemm_csr"]
    r0, r1 = root["ts"], root["ts"] + root["dur"]
    names = {e["name"] for e in spans}
    top = STRIP_TOP if route == "strip" else ESC_TOP
    assert names == {f"spgemm.{n}" for n in top | {"spgemm_csr",
                                                   "download"}}
    for e in spans:
        assert r0 <= e["ts"] and e["ts"] + e["dur"] <= r1 + 1.0, e["name"]
    # a name's events (the ESC route opens route twice: spgemm_csr's
    # estimate and choose_group_rows) as long in the trace as its key
    for n in top:
        us = sum(e["dur"] for e in spans if e["name"] == f"spgemm.{n}")
        assert abs(us / 1e3 - res.timings_ms[f"{n}_ms"]) < 1.0, n
    # the child inside its parent
    (d,) = [e for e in spans if e["name"] == "spgemm.download"]
    (p,) = [e for e in spans if e["name"] == f"spgemm.{PARENT[route]}"]
    assert p["ts"] <= d["ts"] and d["ts"] + d["dur"] <= p["ts"] + p["dur"]


@pytest.mark.parametrize("route", ["strip", "esc"])
def test_routes_fill_their_keys_and_children_fit(route):
    _, (c, res) = _call(route)
    top = STRIP_TOP if route == "strip" else ESC_TOP
    assert set(res.timings_ms) == {f"{n}_ms" for n in top | {"download"}}
    assert ("tile_ms" in res.timings_ms) == (route == "strip")
    tms = res.timings_ms
    assert all(v >= 0.0 for v in tms.values())
    assert tms["download_ms"] <= tms[f"{PARENT[route]}_ms"]
    assert c.nnz == res.stats["nnzC"]


def test_strip_counters_and_upload():
    _, (_, res) = _call("strip")
    s = res.schedule
    up = (s.a_val, s.a_occ, s.b_val, s.b_occ, s.aptr, s.ak, s.slots)
    assert res.stats["h2d_bytes"] == sum(x.nbytes for x in up) \
        + s.gather_idx.size * 8
    # C's entries picked on the device: a keep flag a candidate tile, rc
    # int32 and the f32 value an entry, the kept tiles' mask words and
    # row pointers; no longer every candidate slot's value and bit
    c = res.c
    picked = (s.nt_c + c.nnz * (4 + 4) + c.nt * s.tm * (s.tn // 32) * 4
              + c.nt * (s.tm + 1) * 4)
    assert res.stats["d2h_bytes"] == picked
    assert picked < s.nt_c * s.tm * s.tn * (4 + 4 / 32)
    assert res.timings_ms["upload_ms"] > 0.0


def test_esc_counters():
    _, (c, res) = _call("esc")
    plan = res.schedule
    r = plan.qv.shape[0]
    n_win = plan.win_rowptr.size - 1
    # qv f32 and meta16 per lane, the combine's int64 row indices (each
    # kernel output row of a window up to COMBINE_K rows) and perm; the
    # window sums f32
    assert res.stats["h2d_bytes"] >= r * 128 * 6 + n_win * 8
    assert res.stats["d2h_bytes"] >= n_win * 128 * 4
    assert res.stats["d2h_bytes"] >= c.nnz * 4


def test_device_trace_steps_aside_under_a_profiler(monkeypatch, tmp_path):
    out = tmp_path / "trace"
    monkeypatch.setenv("SPGEMM_TPU_TRACE", str(out))
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.device_trace("inner"):
            torch.ones(8).sum()
        _call("esc")
    assert not out.exists()


def test_cli_prints_the_spans_and_counters(tmp_path, capsys):
    m = sp.random(120, 120, density=0.05, random_state=2, format="csr")
    p = tmp_path / "a.mtx"
    write_mtx(str(p), pt.CSR(m.indptr.astype(np.int32),
                             m.indices.astype(np.int32), m.data, m.shape))
    assert cli_main(["-d", "cpu", str(p), "16", "128", "--backend",
                     "strip"]) == 0
    (line,) = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("step times:")]
    for word in ("route", "tile", "download", "result", "h2d", "d2h"):
        assert f" {word} " in line, word
    assert "h2d -" not in line and "d2h -" not in line
