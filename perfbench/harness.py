"""One run of one cell: set-up, warm-up, the measured window, the trace,
the check against the plain reference, and the metrics.

The cell, its configuration, its traffic and its metrics are found by the
names in BENCHMARK.json; each lives in a file of its own (see the package
docstring), so adding a cell or a metric adds files and edits none.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
import traceback

import numpy as np
import torch

from perfbench import trace
from perfbench.traffic import Traffic

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)
SAMPLED_CALLS = 4
VALUE_BYTES = {"float32": 4, "float64": 8}
FORBIDDEN = ("jax", "jaxlib", "flax", "spgemm_tpu")


def load_module(kind: str, name: str):
    """perfbench/<kind>/<name>.py, by file (a name may hold dots)."""
    path = os.path.join(PKG, kind, name + ".py")
    key = f"perfbench.{kind}.{name}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them: a card
    set below its 700 W maximum runs slower under load."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {e}"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Run:
    """What a run measured, with the cell, configuration and traffic it
    ran: the metric readers take their numbers from it."""

    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    calls: list[dict]                # clock_s, timings_ms, spans, route
    flops_per_call: float
    min_bytes_per_call: float | None
    peak_window_bytes: int
    trace: dict | None = None

    @property
    def done(self) -> list[dict]:
        return [c for c in self.calls if not c.get("failed")]

    def mean_ms(self, fn) -> float | None:
        """Mean over the completed calls of fn(call record), leaving out
        the calls for which fn returns None; None if it returns no value."""
        vals = [v for v in map(fn, self.done) if v is not None]
        return sum(vals) / len(vals) if vals else None

    def phase_ms(self, *keys) -> float | None:
        """Mean per call of the sum of the program's own phase timings
        (SpGEMMResult.timings_ms) under `keys`."""
        return self.mean_ms(
            lambda c: sum(c["timings_ms"].get(k, 0.0) for k in keys)
            if "timings_ms" in c else None)

    def span_ms(self, name: str) -> float | None:
        """Mean per call of one of the harness's own spans."""
        return self.mean_ms(lambda c: c.get("spans", {}).get(name))


class Reservoir:
    """A sample of `k` calls' answers, uniform over the calls of the
    window, drawn from the seed (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        self.k, self.n = k, 0
        self.rng = np.random.default_rng([seed % (1 << 64), 99])
        self.items: list[tuple[int, object]] = []

    def offer(self, call: int, answer_fn) -> None:
        self.n += 1
        if len(self.items) < self.k:
            self.items.append((call, answer_fn()))
            return
        j = int(self.rng.integers(0, self.n))
        if j < self.k:
            self.items[j] = (call, answer_fn())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def open_cell(bench: dict, name: str, seed: int, device, config=None):
    """(cell, config, traffic spec, product module, entry module, Traffic)
    of cell `name`, each found by its name; `config` replaces the cell's
    configuration file."""
    cell = next(w for w in bench["workloads"] if w["name"] == name)
    cfg_meta = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = config if config is not None else load_json(ROOT, cfg_meta["file"])
    spec = load_json(PKG, "traffic", cell["traffic"] + ".json")
    matrix = load_module("matrices", cfg["generator"]).build(cfg)
    return (cell, cfg, spec, load_module("products", spec["product"]),
            load_module("entries", spec["entry"]),
            Traffic(spec, cfg, matrix, load_module("variations", spec["vary"]),
                    seed, device))


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool,
             device, t_start: float, config: dict | None = None,
             entry_wrap=None) -> tuple[dict, list[str]]:
    """Runs cell `name` once. Returns (result, lines): the result object
    the command prints last, and the compared numbers beside their limits.

    `config` replaces the cell's configuration file (the tests run cells
    at small sizes with it); `entry_wrap(entry)` lets a test break the
    timed path underneath the harness."""
    dev = torch.device(device)
    marks = [("start", time.perf_counter())]
    cell, cfg, spec, product, entry_mod, traffic = open_cell(
        bench, name, seed, dev, config)
    base = traffic.inputs(-1)
    marks.append(("inputs", time.perf_counter()))
    entry = entry_mod.Entry(cfg, spec, base, dev)
    marks.append(("entry", time.perf_counter()))
    if entry_wrap is not None:
        entry = entry_wrap(entry)
    warm = traffic.inputs(0)
    flops = product.useful_flops(warm)
    entry(entry.prepare(warm))        # builds and warms every kernel
    del warm
    _sync(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_peak = _peak(dev)
    log(f"# set-up: {marks[0][1] - t_start:.3f} s to the cell, then " + ", ".join(
        f"{k} {t - marks[j][1]:.3f} s" for j, (k, t) in enumerate(marks[1:])))

    sample = Reservoir(SAMPLED_CALLS, seed)
    calls: list[dict] = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = trace.start(dev) if traced else None
    span = trace.call_span if traced else trace.no_span
    setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    i = 0
    while time.perf_counter() - w0 < seconds:
        i += 1
        prepared = entry.prepare(traffic.inputs(i))
        rec: dict = {"call": i}
        try:
            with span():
                t0 = time.perf_counter()
                out = entry(prepared)
                rec["clock_s"] = time.perf_counter() - t0
        except Exception:  # a failed call is counted, and the run goes on
            log(f"call {i} failed:\n{traceback.format_exc()}")
            rec["failed"] = True
            calls.append(rec)
            continue
        rec.update(entry.last)
        calls.append(rec)
        sample.offer(i, lambda: entry.to_host(out))
        del out, prepared
    _sync(dev)
    window_s = time.perf_counter() - w0
    peak = _peak(dev)
    summary = trace.stop(prof) if traced else None

    entry.close()
    del entry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    numbers: dict[str, float] = {}
    min_bytes = None
    c0 = time.perf_counter()
    for call, answer in sample.items:
        inp = traffic.inputs(call)
        ref = product.reference_of(inp, dev)
        got = product.compare(answer, ref, inp, dev)
        min_bytes = product.min_bytes(inp, ref, VALUE_BYTES[cfg["dtype"]])
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, v), v)
        del ref
    log(f"# check of {len(sample.items)} calls took "
        f"{time.perf_counter() - c0!r} s")
    limits = spec["limits"]
    failed = sum(1 for c in calls if c.get("failed"))
    correct = failed == 0 and bool(sample.items) and all(
        numbers.get(k, float("inf")) <= lim for k, lim in limits.items())

    run = Run(cell=cell, config=cfg, traffic=spec, setup_s=setup_s,
              window_s=window_s, calls=calls, flops_per_call=flops,
              min_bytes_per_call=min_bytes, peak_window_bytes=peak,
              trace=summary)
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if "workloads" in m and name not in m["workloads"]:
            continue
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(max(setup_peak, peak)),
    }
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    routes = dict(collections.Counter(c.get("route", "?") for c in calls))
    log(f"# {name}: {len(calls)} calls in {window_s!r} s, routes {routes}, "
        f"checked calls {[c for c, _ in sample.items]}")
    log("# call ms: " + " ".join(
        f"{c['clock_s'] * 1e3:.1f}" + (f"[{c['route']}]" if "G=" in
                                       c.get("route", "") else "")
        for c in calls if "clock_s" in c))
    checked = {k: {"value": numbers.get(k), "limit": lim}
               for k, lim in limits.items()}
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checked"] = checked
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
             for k, v in checked.items()]
    return result, lines
