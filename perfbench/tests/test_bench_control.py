"""The control of `correct`: the plain reference one precision step below
the configuration's (float32 inputs rounded to TF32, float32 sums), put
in the program's place under the harness, must come out not correct.

The CPU test runs every cell at a small size. The card test runs each
cell at its own size, on three seeds, with a short window, and prints
the numbers compared: the smallest of them over the seeds is the upper
reading that each limit is set below (PERF.md)."""

import json
import time

import pytest

from conftest import full_config, small_config
from perfbench import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT,
                                             "BENCHMARK.json")["workloads"]]
CARD_SEEDS = [2**32 + 11, 2**32 + 23, 2**32 + 37]


class Control:
    """Wraps an entry and answers each call with the product's control
    in the form the program returns it; the program is never called."""

    def __init__(self, entry, product, device):
        self.entry, self.product, self.device = entry, product, device
        self.last = {}

    @staticmethod
    def prepare(inp):
        return inp

    def __call__(self, inp):
        return self.product.control_answer(
            self.product.reference_of(inp, self.device, control=True))

    @staticmethod
    def to_host(out):
        return out

    def close(self):
        self.entry.close()


def run_control(bench, name, seed, seconds, device, config):
    spec = harness.load_json(harness.PKG, "traffic", next(
        w for w in bench["workloads"] if w["name"] == name)["traffic"]
        + ".json")
    product = harness.load_module("products", spec["product"])
    return harness.run_cell(
        bench, name, seed, seconds, False, device, time.perf_counter(),
        config=config,
        entry_wrap=lambda e: Control(e, product, torch_device(device)))


def torch_device(device):
    import torch

    return torch.device(device)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(bench, name):
    res, lines = run_control(bench, name, 2**31 + 9, 0.3, "cpu",
                             small_config(bench, name))
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["correct"] is False, lines
    assert any(v["value"] > v["limit"] for v in res["checked"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", CARD_SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_at_full_size(bench, name, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res, lines = run_control(bench, name, seed, 2.0, "cuda",
                             full_config(bench, name))
    print(json.dumps({"control": name, "seed": seed,
                      "checked": res["checked"]}))
    assert res["correct"] is False, lines
