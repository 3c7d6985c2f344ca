"""The traced stretch of a run: torch.profiler over CPU and CUDA, exported
as a Chrome trace into the run's temporary directory and reduced to the
record that the per-layer metric readers take.

A kernel belongs to a span when the host call that launched it (the CUDA
runtime or driver event with the kernel's correlation id) lies inside
the span's interval, on any thread: autograd launches a backward's
kernels from a thread of its own, and no other thread of these cells
launches kernels. The device is busy where any kernel, copy or memset
runs; the window is the `bench::window` span, so busy_s is the union of
device intervals clipped to it."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, List

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


@contextmanager
def profiled(spans, out: dict, sync: bool):
    """Profile the body with CPU and CUDA activities, spans on, inside a
    `bench::window` span; fill `out` with the reduced record on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if sync:
        acts.append(ProfilerActivity.CUDA)
    spans.reset()
    spans.on = True
    with profile(activities=acts) as prof:
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with record_function("bench::window"):
            yield
            if sync:
                torch.cuda.synchronize()
        window = time.perf_counter() - t0
    spans.on = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out.update(reduce(events, window))


def _union(intervals: List[tuple]) -> List[tuple]:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def reduce(events: list, window_host_s: float) -> dict:
    """The record: window_s, busy_s, the device seconds of the kernels
    launched inside each span, and the breakdown: the device ops that took
    most time and the idle gaps by the innermost span open at their
    start."""
    launches, kernels, spans = {}, [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        args = e.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = e["ts"]
        elif cat in DEVICE_CATS:
            kernels.append(e)
        elif cat == "user_annotation" and e["name"].startswith("bench::"):
            spans.setdefault(e["name"][7:], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
    win = spans.get("window", [(0.0, float("inf"))])[0]
    ks = []
    for e in kernels:
        a, b = max(e["ts"], win[0]), min(e["ts"] + e.get("dur", 0), win[1])
        if b <= a:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        ks.append({"name": e["name"], "start": a, "end": b,
                   "launch": launch})
    busy = _union([(k["start"], k["end"]) for k in ks])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    window_s = (win[1] - win[0]) * 1e-6 if win[1] != float("inf") \
        else window_host_s

    device_s: Dict[str, float] = {}
    for name, ivs in spans.items():
        if name == "window":
            continue
        lst = sorted(ivs)
        ends = _running_max([b for _, b in lst])
        total = 0.0
        for k in ks:
            if k["launch"] is None:
                continue
            i = bisect.bisect_right(lst, (k["launch"], float("inf"))) - 1
            if i >= 0 and k["launch"] <= ends[i]:
                total += k["end"] - k["start"]
        device_s[name] = total * 1e-6

    ops: Dict[str, float] = {}
    for k in ks:
        ops[k["name"]] = ops.get(k["name"], 0.0) + (k["end"] - k["start"])
    device_ops = sorted(([n, s * 1e-6] for n, s in ops.items()),
                        key=lambda x: -x[1])[:TOP]
    gaps: Dict[str, float] = {}
    edges = [(win[0], win[0])] + busy + [(win[1], win[1])] \
        if win[1] != float("inf") else busy
    host_spans = sorted((a, b, n) for n, ivs in spans.items()
                        if n != "window" for a, b in ivs)
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b <= a:
            continue
        gaps[_open_span(host_spans, a)] = gaps.get(
            _open_span(host_spans, a), 0.0) + (b - a) * 1e-6
    idle_gaps = sorted(([n, s] for n, s in gaps.items()),
                       key=lambda x: -x[1])[:TOP]
    return {"window_s": window_s, "busy_s": busy_s, "device_s": device_s,
            "breakdown": {"device_ops": device_ops, "idle_gaps": idle_gaps}}


def _running_max(values: List[float]) -> List[float]:
    out, m = [], float("-inf")
    for v in values:
        m = max(m, v)
        out.append(m)
    return out


def _open_span(spans: list, t: float) -> str:
    """The innermost (latest-starting) benchmark span open at host time
    t, or "other"."""
    best = None
    for a, b, n in spans:
        if a > t:
            break
        if b >= t:
            best = n
    return best or "other"
