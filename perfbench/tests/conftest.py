"""Tests of the benchmark harness. They run on the CPU through the
program's plain versions at small sizes; a test that needs the card is
marked `cuda` and decides inside itself whether to skip."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

# the configurations at sizes a CPU test run holds
SMALL = {"top3d": {"nelx": 12, "nely": 4, "nelz": 2},
         "graph500_s14": {"scale": 9}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture(scope="session")
def bench():
    return harness.load_json(harness.ROOT, "BENCHMARK.json")


def full_config(bench, cell_name):
    cell = next(w for w in bench["workloads"] if w["name"] == cell_name)
    meta = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return harness.load_json(harness.ROOT, meta["file"])


def small_config(bench, cell_name):
    cfg = full_config(bench, cell_name)
    cfg.update(SMALL[next(w for w in bench["workloads"]
                          if w["name"] == cell_name)["config"]])
    return cfg
