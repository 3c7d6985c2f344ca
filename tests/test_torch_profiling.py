"""The port's tracer (ws3d_tpu_torch.utils.profiling): off outside a torch
profiler recording, its spans in the profiler's trace on the clock of the
ops inside them, its totals and counters of the last recording, spans on
the prefetch thread, spans cut by a recording's start or end, and
trace_context's two files."""
from __future__ import annotations

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets.boxplace_dataset import (
    BoxPlaceDataset, synthetic_proposal_database)
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.ops.nms import greedy_suppress
from ws3d_tpu_torch.tools.train_cascade import configure
from ws3d_tpu_torch.training.trainer import Trainer
from ws3d_tpu_torch.utils import profiling
from ws3d_tpu_torch.utils.prefetch import prefetch
from ws3d_tpu_torch.utils.profiling import TRACE, count, span, trace_context

K = 24
NPOINTS = 64


def _sweep_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((2, K, K), generator=g), 0.5,
            torch.rand((2, K), generator=g) > 0.2)


def _loader(steps):
    cfg = load_config()
    configure(cfg, "rcnn", NPOINTS)
    db = synthetic_proposal_database(num=8, seed=1, crop_points=NPOINTS)
    ds = BoxPlaceDataset(db, cfg, mode="TRAIN", npoints=NPOINTS, seed=0)
    return cfg, ds.batches(4, steps=steps)


def _train(n_steps):
    cfg, batches = _loader(n_steps)
    model = build_model(cfg, device="cpu", seed=0)
    trainer = Trainer(model, cfg, total_steps=10, stage="rcnn", seed=0,
                      log_fn=lambda s: None)
    trainer.train_steps(batches, n_steps, log_every=10**9, prefetch_size=2)


def _refused(*args, **kwargs):
    raise AssertionError("the tracer acted while no profiler recorded")


class _NoClock:
    perf_counter = staticmethod(_refused)


class _NoLock:
    __enter__ = __exit__ = _refused


def test_off_records_nothing_and_takes_no_clock_or_lock(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        pass                                 # an empty last recording
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _refused)
        m.setattr(profiling, "time", _NoClock)
        m.setattr(TRACE, "_lock", _NoLock())
        greedy_suppress(*_sweep_inputs())
        assert list(prefetch(iter(range(5)), size=2)) == list(range(5))
        _train(2)
        with span("off"):
            count("off", 3)
    assert TRACE.totals() == {"spans": {}, "counters": {}}
    assert TRACE.spans() == []


def test_sweep_span_is_in_the_trace_around_its_ops(tmp_path):
    pair, thresh, valid = _sweep_inputs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        keep = [greedy_suppress(pair, thresh, valid) for _ in range(3)]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    sweeps = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e["name"] == "ws3d::nms.sweep"]
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e["name"].startswith("aten::")]
    assert len(sweeps) == 3 and ops
    # every op of the block ran inside a sweep, on the trace's own clock
    assert all(any(a <= s and t <= b for a, b in sweeps) for s, t in ops)
    tot = TRACE.totals()
    assert tot["spans"]["nms.sweep"]["calls"] == 3
    assert tot["counters"] == {"nms.sweep_steps": 3 * K}
    host = tot["spans"]["nms.sweep"]["host_s"]
    traced = sum(b - a for a, b in sweeps) * 1e-6
    # the host clock reads inside the range's ends (to the trace's us)
    assert 0 < host <= traced + 3 * 2e-6
    spans = TRACE.spans()
    assert [s["name"] for s in spans] == ["nms.sweep"] * 3
    assert all(s["thread"] == "MainThread" and s["parent"] is None
               and s["end"] > s["start"] for s in spans)
    for k in keep:
        assert torch.equal(k, keep[0])


def test_prefetch_thread_spans_are_counted(monkeypatch):
    _, batches = _loader(2)
    ranges = []
    record_function = torch.profiler.record_function

    def traced_range(name):
        ranges.append((name, threading.current_thread().name))
        return record_function(name)
    monkeypatch.setattr(torch.profiler, "record_function", traced_range)
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(prefetch(batches, size=2))
    # the prefetch thread is not recorded, so its spans open no range
    assert ranges == [("ws3d::prefetch.wait", "MainThread")] * 3
    assert len(got) == 2
    tot = TRACE.totals()["spans"]
    assert tot["loader.batch"]["calls"] == 2
    assert tot["loader.sample"]["calls"] == 8
    assert tot["prefetch.wait"]["calls"] == 3      # two batches, the end
    spans = TRACE.spans()
    batch_ids = {s["id"] for s in spans if s["name"] == "loader.batch"}
    samples = [s for s in spans if s["name"] == "loader.sample"]
    assert all(s["parent"] in batch_ids for s in samples)
    assert all(s["thread"] != "MainThread" for s in samples)
    assert tot["loader.sample"]["host_s"] < tot["loader.batch"]["host_s"]


def test_trainer_spans_carry_the_step():
    _train(3)                                    # an untraced first call
    with profile(activities=[ProfilerActivity.CPU]):
        _train(3)
    tot = TRACE.totals()["spans"]
    for name in ("trainer.step", "trainer.to_device", "trainer.backward"):
        assert tot[name]["calls"] == 3, name
    spans = TRACE.spans()
    steps = {s["id"]: s["step"] for s in spans if s["name"] == "trainer.step"}
    assert sorted(steps.values()) == [0, 1, 2]
    back = [s for s in spans if s["name"] == "trainer.backward"]
    assert all(s["parent"] in steps and s["step"] == steps[s["parent"]]
               for s in back)
    assert tot["trainer.backward"]["host_s"] < tot["trainer.step"]["host_s"]


@pytest.mark.parametrize("cut", ["start", "end"])
def test_a_cut_span_adds_nothing(cut):
    outer = span("cut")
    if cut == "start":
        outer.__enter__()
    with profile(activities=[ProfilerActivity.CPU]):
        if cut == "end":
            outer.__enter__()
        with span("whole"):
            count("whole")
        if cut == "start":
            outer.__exit__(None, None, None)
    if cut == "end":
        outer.__exit__(None, None, None)
    assert TRACE.totals()["spans"].keys() == {"whole"}
    assert TRACE.totals()["counters"] == {"whole": 1}
    # opened inside the recording, the cut span still parents "whole"
    parent = None if cut == "start" else 0
    assert [s["parent"] for s in TRACE.spans()] == [parent]


def test_a_second_recording_starts_from_zero():
    args = _sweep_inputs()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]):
            greedy_suppress(*args)
        tot = TRACE.totals()
        assert tot["spans"]["nms.sweep"]["calls"] == 1
        assert tot["counters"]["nms.sweep_steps"] == K
    span_open = span("across")
    with profile(activities=[ProfilerActivity.CPU]):
        span_open.__enter__()
    with profile(activities=[ProfilerActivity.CPU]):
        span_open.__exit__(None, None, None)   # opened in the first
    assert TRACE.totals() == {"spans": {}, "counters": {}}


def test_span_as_decorator_keeps_the_function():
    @span("decorated")
    def f(x, y=1):
        """f's doc."""
        return x + y

    assert f.__name__ == "f" and f.__doc__ == "f's doc."
    assert f(1, y=2) == 3
    with profile(activities=[ProfilerActivity.CPU]):
        assert f(2) == 3
    assert TRACE.totals()["spans"]["decorated"]["calls"] == 1


def test_trace_context_writes_the_trace_and_the_spans(tmp_path):
    with trace_context(None) as prof:
        assert prof is None
    out = tmp_path / "profile"
    with trace_context(str(out)):
        greedy_suppress(*_sweep_inputs())
    trace = json.loads((out / "trace.json").read_text())
    assert any(e.get("name") == "ws3d::nms.sweep"
               for e in trace["traceEvents"])
    spans = json.loads((out / "spans.json").read_text())
    assert spans["spans"][0]["name"] == "nms.sweep"
    assert spans["spans"][0]["thread"] == "MainThread"
    assert spans["totals"] == {"nms.sweep": {
        "calls": 1, "host_s": spans["spans"][0]["end"]
        - spans["spans"][0]["start"]}}
    assert spans["counters"] == {"nms.sweep_steps": K}


def test_eval_auto_profile_dir(tmp_path):
    from ws3d_tpu_torch.tools import eval_auto
    out = tmp_path / "profile"
    assert eval_auto.main([
        "--synthetic", "--scenes", "2", "--points", "2048", "--cpu",
        "--no_ap", "--set", "TPU.MAX_PROPOSALS=8",
        "--output_dir", str(tmp_path), "--profile_dir", str(out)]) == 0
    spans = json.loads((out / "spans.json").read_text())
    for name in ("rpn.forward", "inference.propose", "nms.sweep",
                 "rcnn.trunk", "inference.finalize", "kitti_io.save"):
        assert spans["totals"][name]["calls"] >= 2, name
    # two scenes at batch 1: K 512 and 8 host steps each
    assert spans["counters"]["nms.sweep_steps"] == 2 * (512 + 8)
    assert (out / "trace.json").stat().st_size > 0


def test_train_cascade_profile_dir(tmp_path):
    from ws3d_tpu_torch.tools import train_cascade
    out = tmp_path / "profile"
    assert train_cascade.main([
        "--stage", "rcnn", "--synthetic", "--steps", "2", "--batch", "4",
        "--npoints", str(NPOINTS), "--db_size", "8", "--val_ratio", "0",
        "--device", "cpu", "--output_dir", str(tmp_path),
        "--profile_dir", str(out)]) == 0
    spans = json.loads((out / "spans.json").read_text())
    for name in ("trainer.step", "trainer.to_device", "trainer.backward"):
        assert spans["totals"][name]["calls"] == 2, name
    assert spans["totals"]["loader.sample"]["calls"] >= 8
    assert {s["step"] for s in spans["spans"]
            if s["name"] == "trainer.step"} == {0, 1}
    assert (out / "trace.json").stat().st_size > 0
