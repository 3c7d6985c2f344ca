"""Timing and tracing helpers (port of ws3d_tpu/utils/profiling.py).

CUDA work is asynchronous: a host clock around it measures the enqueue.
force_sync and Timer close on torch.cuda.synchronize() where the tree they
are given holds a CUDA tensor; trace_context records a torch.profiler
trace (the card's kernels too, where there is one) into a directory.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


def _cuda_devices(tree) -> set:
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in tree)) if tree \
            else set()
    return set()


def force_sync(tree) -> None:
    """Wait for the devices of the CUDA tensors in `tree` (nested dicts,
    lists and tuples) to finish their queued work."""
    for device in _cuda_devices(tree):
        torch.cuda.synchronize(device)


class Timer:
    """Wall-clock seconds of a block (`elapsed`); with `sync_tree`, the
    queued work of its devices is finished before the clock starts and
    before it stops."""

    def __init__(self, sync_tree=None):
        self._sync = sync_tree

    def __enter__(self):
        if self._sync is not None:
            force_sync(self._sync)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            force_sync(self._sync)
        self.elapsed = time.perf_counter() - self.t0
        return False


class ThroughputMeter:
    """Items a second after `warmup` ticks (the first ticks discarded)."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.count = 0
        self.items = 0
        self.t0: Optional[float] = None

    def tick(self, n_items: int = 1):
        self.count += 1
        if self.count == self.warmup:
            self.t0 = time.perf_counter()
            self.items = 0
        elif self.count > self.warmup:
            self.items += n_items

    @property
    def per_sec(self) -> float:
        if self.t0 is None or self.items == 0:
            return 0.0
        return self.items / (time.perf_counter() - self.t0)


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]):
    """A torch.profiler trace of the block (CPU, and CUDA where a device
    is visible) written to LOG_DIR/trace.json; nothing without log_dir."""
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
