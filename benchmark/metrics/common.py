"""The readers' arithmetic (a reader is benchmark/metrics/<quantity>.py
with read(record) -> number or None; see harness.read_metric)."""
from __future__ import annotations

from benchmark.roofline.counts import fps_bound_s, fused_sa_bound_s


def span_device_ms(rec: dict, *names: str):
    """Device ms an iteration of the kernels launched inside the spans."""
    d = rec.get("device_s", {})
    s = sum(d.get(n, 0.0) for n in names)
    return None if not s else s * 1e3 / rec["iters"]


def host_ms(rec: dict, *names: str):
    """Host ms an iteration inside the spans."""
    h = rec.get("host_s", {})
    if names[0] not in h:
        return None
    return sum(h.get(n, 0.0) for n in names) * 1e3 / rec["iters"]


def mean_ms(rec: dict, key: str):
    d = rec.get(key)
    return None if not d else sum(d) * 1e3 / len(d)


def roofline_pct(rec: dict, span: str, bound):
    """The calls' least times over their kernels' device time, in %."""
    calls = rec.get("calls", {}).get(span)
    t = rec.get("device_s", {}).get(span)
    if not calls or not t:
        return None
    return 100.0 * sum(bound(c) for c in calls) / t


def fused_sa_roofline(rec: dict):
    return roofline_pct(rec, "fused_sa", fused_sa_bound_s)


def fps_roofline(rec: dict):
    return roofline_pct(rec, "fps", fps_bound_s)


def idle_pct(rec: dict):
    if not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def mfu_pct(rec: dict, flops_factor: float, peak: float):
    if not rec.get("flops") or not rec.get("window_s"):
        return None
    return 100.0 * flops_factor * rec["flops"] / (rec["window_s"] * peak)
