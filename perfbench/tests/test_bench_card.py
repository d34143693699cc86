"""Every cell at a small size on the card (skips without one)."""

import time

import pytest

from conftest import small_config
from perfbench import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT,
                                             "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(bench, name, traced):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res, lines = harness.run_cell(bench, name, 2**31 + 3, 0.5, traced,
                                  "cuda", time.perf_counter(),
                                  config=small_config(bench, name))
    assert res["correct"] is True, lines
    if traced:
        assert res["device"]["busy_s"] > 0
        assert 0 < res["metrics"]["kernels_roofline"]["value"] <= 105
