"""The traced run's device timeline: torch.profiler over the window, its
Chrome trace written under TMPDIR, read, and deleted.

Every timed call runs inside a `bench.call` span (record_function), so the
summary counts only what happens inside calls: the harness's own work
between calls (drawing the next inputs) is left out of every number.
  window_s     the summed length of the call spans
  busy_s       the time inside them in which a kernel, memset or copy ran
               on the device (the union of their intervals)
  kernel_s     summed device time of kernels and memsets inside them
  copy_s       summed device time of host<->device and device copies
  device_ops   device time by operation name, the largest first
  idle_gaps    device-idle time inside the spans by what the host was
               doing: the innermost profiled host operation under the
               gap's middle, else the device operation the gap follows
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import numpy as np
import torch

CALL_SPAN = "bench.call"
_KERNEL = ("kernel", "gpu_memset")
_COPY = ("gpu_memcpy",)


def start(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def call_span():
    return torch.profiler.record_function(CALL_SPAN)


def no_span():
    return contextlib.nullcontext()


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(s, e, spans, i0):
    """(clipped duration, index of the first span that can still overlap
    a later interval) of [s, e) against the sorted, disjoint spans."""
    i = i0
    while i < len(spans) and spans[i][1] <= s:
        i += 1
    tot, j = 0.0, i
    while j < len(spans) and spans[j][0] < e:
        tot += max(0.0, min(e, spans[j][1]) - max(s, spans[j][0]))
        j += 1
    return tot, i


def summarise(events: list[dict], top: int = 10) -> dict:
    """The summary above from a Chrome trace's events (times in us)."""
    spans = _union([(e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == CALL_SPAN
                    and e.get("cat") == "user_annotation"])
    dev = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["cat"], e["name"])
                  for e in events if e.get("cat") in _KERNEL + _COPY),
                 key=lambda d: d[0])
    kernel_us = copy_us = 0.0
    by_name: dict[str, float] = {}
    inside = []
    i0 = 0
    for s, e, cat, name in dev:
        d, i0 = _clip(s, e, spans, i0)
        if d <= 0:
            continue
        if cat in _KERNEL:
            kernel_us += d
        else:
            copy_us += d
        by_name[name] = by_name.get(name, 0.0) + d
        inside.append((s, e, name))
    busy = _union([(s, e) for s, e, _ in inside])
    busy_us = sum(_clip(s, e, spans, 0)[0] for s, e in busy)
    window_us = sum(e - s for s, e in spans)

    host = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"])
            for e in events if e.get("cat") == "cpu_op"]
    h_s = np.array([h[0] for h in host], float)
    h_e = np.array([h[1] for h in host], float)
    d_e = np.array([d[1] for d in inside], float)
    gaps: dict[str, float] = {}
    for ss, se in spans:
        t, started = ss, False
        for bs, be in [b for b in busy if b[1] > ss and b[0] < se] + [
                [se, se]]:
            if bs > t:
                name = _gap_name(t, min(bs, se), host, h_s, h_e, inside,
                                 d_e, started)
                gaps[name] = gaps.get(name, 0.0) + (min(bs, se) - t)
            t, started = max(t, be), True
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {
        "window_s": window_us / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": kernel_us / 1e6,
        "copy_s": copy_us / 1e6,
        "device_ops": [[k, v / 1e6] for k, v in order(by_name)],
        "idle_gaps": [[k, v / 1e6] for k, v in order(gaps)],
    }


def _gap_name(s, e, host, h_s, h_e, inside, d_e, started) -> str:
    mid = 0.5 * (s + e)
    under = np.flatnonzero((h_s <= mid) & (h_e > mid))
    if under.size:
        h = host[under[np.argmin(h_e[under] - h_s[under])]]
        return "host op " + h[2]
    if not started:
        return "host code at the call's start"
    before = np.flatnonzero(d_e <= s + 1e-3)
    if not before.size:
        return "host code at the call's start"
    return "host code after " + inside[before[np.argmax(d_e[before])]][2][:80]


def stop(prof) -> dict:
    """Ends the profiler and returns summarise() of its trace."""
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(prefix="perfbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarise(events)
