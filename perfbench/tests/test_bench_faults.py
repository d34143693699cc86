"""The check that decides `correct` fails a run whose timed path is
broken underneath the harness, once for each fault a cell can have:
a step that returns its state unchanged (the first answer, again), half
of the rows left out, and one answer altered where it is produced."""

import time

import numpy as np
import pytest

from conftest import small_config
from perfbench import harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT,
                                             "BENCHMARK.json")["workloads"]]


class Broken:
    """Wraps an entry; `fault` rewrites each answer it returns."""

    def __init__(self, entry, fault):
        self.entry, self.fault, self.first = entry, fault, None
        self.last = {}

    def prepare(self, inp):
        return self.entry.prepare(inp)

    def __call__(self, prepared):
        out = self.entry(prepared)
        self.last = self.entry.last
        host = self.entry.to_host(out)
        if self.first is None:
            self.first = host
        return self.fault(self, host)

    @staticmethod
    def to_host(out):
        return out

    def close(self):
        self.entry.close()


def stale(self, host):
    return self.first


def half_rows(self, host):
    indptr, indices, data = host
    m = indptr.size - 1
    cut = int(indptr[m // 2])
    ip = indptr.copy()
    ip[m // 2:] = cut
    return ip, indices[:cut], data[:cut]


def altered(self, host):
    indptr, indices, data = host
    d = np.array(data, copy=True)
    d[np.argmax(np.abs(d))] *= -1.0
    return indptr, indices, d


@pytest.mark.parametrize("fault", [stale, half_rows, altered],
                         ids=["state_unchanged", "half_rows", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(bench, name, fault):
    res, lines = harness.run_cell(
        bench, name, 2**31 + 77, 1.0, False, "cpu", time.perf_counter(),
        config=small_config(bench, name),
        entry_wrap=lambda e: Broken(e, fault))
    assert res["attempted"] >= 1
    assert res["correct"] is False, lines
