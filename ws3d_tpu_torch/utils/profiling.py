"""The port's tracing: named spans and counters at its layer boundaries,
and the exporter of a profiled stretch.

    from ws3d_tpu_torch.utils.profiling import count, span

    with span("inference.compact"):          # or @span("loader.sample")
        ...
    count("nms.sweep_steps", K)

One process-wide tracer, TRACE, is on exactly while a torch profiler is
recording (torch.profiler.profile, torch.autograd.profiler.profile,
trace_context): a profiled stretch gets the program's spans with no switch
of its own. Off, a span or a count tests that one process-wide flag and
does nothing else: no record_function, no clock, no lock.

On, a span keeps its name, start and end (time.perf_counter), parent
span, thread and step (the Trainer's, or its parent's) in memory, with the
calls and host seconds of each name, and on a thread the profiler records
it opens torch.profiler.record_function("ws3d::<name>"), so it lies in the
profiler's trace on the clock of the kernels launched inside it. A plain
Python thread (the prefetch thread, the benchmark's writer) is not
recorded, so its spans reach TRACE and not the trace. A span counts only
if the same recording was on when it opened and when it closed; a new
recording starts the totals from zero. TRACE.totals() gives those of the
last recording.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler


class Tracer:
    """Spans and counters of the current (or last) profiler recording."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.recording = 0          # recordings started in this process
        self._cut = []              # ranges cut by a new recording
        self._reset()

    def _reset(self):
        self._ids = itertools.count()
        self._spans = []
        self._totals = {}
        self._counters = {}

    def new_recording(self) -> None:
        """Called as a torch profiler starts: the totals start from zero."""
        with self._lock:
            self.recording += 1
            self._reset()

    def _open(self, name: str, step: Optional[int]) -> tuple:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        if parent is not None and step is None:
            step = parent[3]
        # a range only where the profiler records this thread: elsewhere it
        # would not reach the trace, and opening it still slows the others
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function("ws3d::" + name)
            rf.__enter__()
        # (name, id, parent's id, step, recording, range, start)
        frame = (name, next(self._ids), None if parent is None else parent[1],
                 step, self.recording, rf, time.perf_counter())
        stack.append(frame)
        return frame

    def _close(self, frame: tuple) -> None:
        t1 = time.perf_counter()
        name, sid, parent, step, recording, rf, t0 = frame
        stack = self._local.stack
        while stack and stack.pop() is not frame:
            pass
        if recording != self.recording:
            # cut by a new recording: its range is kept open for good, since
            # ending a range of an earlier recording (by closing it or
            # freeing it) can crash torch's profiler when the new one stops
            self._cut.append(rf)
            return
        if rf is not None:
            rf.__exit__(None, None, None)
        if not _profiler._is_profiler_enabled:
            return                      # cut by the end of the recording
        with self._lock:
            if recording != self.recording:
                return
            self._spans.append((sid, parent, name,
                                threading.current_thread().name, step, t0,
                                t1))
            tot = self._totals.setdefault(name, {"calls": 0, "host_s": 0.0})
            tot["calls"] += 1
            tot["host_s"] += t1 - t0

    def _add(self, name: str, n: int) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def totals(self) -> dict:
        """{"spans": {name: {"calls", "host_s"}}, "counters": {name: n}}
        of the last recording."""
        with self._lock:
            return {"spans": {k: dict(v) for k, v in self._totals.items()},
                    "counters": dict(self._counters)}

    def spans(self) -> list:
        """The last recording's spans, in the order they closed."""
        keys = ("id", "parent", "name", "thread", "step", "start", "end")
        with self._lock:
            return [dict(zip(keys, s)) for s in self._spans]


TRACE = Tracer()


def _hook_profiler_start() -> None:
    """Tell TRACE when any torch profiler starts recording (torch calls
    this module-level hook of torch.autograd.profiler at each start)."""
    start = _profiler._run_on_profiler_start

    def on_start():
        TRACE.new_recording()
        start()
    _profiler._run_on_profiler_start = on_start


_hook_profiler_start()


class span:
    """A named span of TRACE: `with span(name):` or `@span(name)`. `step`
    tags it (and the spans inside it) with a step number."""

    __slots__ = ("name", "step", "_frame")

    def __init__(self, name: str, step: Optional[int] = None):
        self.name, self.step, self._frame = name, step, None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._frame = TRACE._open(self.name, self.step)
        return self

    def __exit__(self, *exc):
        if self._frame is not None:
            TRACE._close(self._frame)
            self._frame = None
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)
        return wrapped


def count(name: str, n: int = 1) -> None:
    """Add n to TRACE's counter `name` (while a profiler records)."""
    if _profiler._is_profiler_enabled:
        TRACE._add(name, n)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU, and CUDA where a device
    is visible) written to LOG_DIR/trace.json, and TRACE's spans, totals
    and counters of it to LOG_DIR/spans.json; nothing without log_dir."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    totals = TRACE.totals()
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"spans": TRACE.spans(), "totals": totals["spans"],
                   "counters": totals["counters"]}, f)
