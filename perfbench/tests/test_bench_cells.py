"""Every cell of BENCHMARK.json, at a small size on the CPU through the
program's plain versions: the result object, its keys and its checks;
the command's behaviour without a card."""

import io
import json
import os
import shutil
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

from conftest import ROOT, small_config
from perfbench import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT,
                                             "BENCHMARK.json")["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(bench, name, traced, **kw):
    return harness.run_cell(bench, name, 2**31 + 101, 0.3, traced, "cpu",
                            time.perf_counter(),
                            config=small_config(bench, name), **kw)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(bench, name, traced):
    res, lines = _run(bench, name, traced)
    assert list(res) == KEYS + (["breakdown"] if traced else []) + ["checked"]
    assert res["correct"] is True, lines
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["count"] == 1
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    spec = harness.load_json(harness.PKG, "traffic", cell["traffic"] + ".json")
    assert set(res["checked"]) == set(spec["limits"])
    assert len(lines) == len(spec["limits"])
    kind = "per_layer" if traced else "end_to_end"
    for m in bench[kind]:
        if m["name"] in res["metrics"]:
            assert res["metrics"][m["name"]]["unit"] == m["unit"]
            assert "workloads" not in m or name in m["workloads"]
    if not traced:
        # a CPU run reports no device number (its peak reads 0)
        assert set(res["metrics"]) >= {"setup_s", "e2e_gflops"}
        assert "peak_device_gib" not in res["metrics"]
    else:
        assert not {"kernels_roofline", "device_idle_pct",
                    "copy_ms"} & set(res["metrics"])
        assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_run_prints_one_result_last(bench, monkeypatch):
    import torch

    from perfbench import run

    real = harness.run_cell
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(
        harness, "run_cell",
        lambda b, name, seed, seconds, traced, device, t0: real(
            b, name, seed, seconds, traced, "cpu", t0,
            config=small_config(bench, name)))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "top3d.a2", "--seed", "7",
                       "--seconds", "0.2", "--trace", "0"])
    assert rc == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last) == KEYS + ["checked"]
    assert last["correct"] is True


def test_no_card_no_result():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "top3d.a2",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def test_alone_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload", "top3d.a2",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
