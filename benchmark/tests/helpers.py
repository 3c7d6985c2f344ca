"""Small CPU runs of the benchmark's cells for the tests: the same drivers
and check of outputs at sizes a test run holds. The small inference runs
compute in float32: the limits are read at the cells' own sizes on the
card, where bf16 sits well inside them, while a few small CPU scenes in
bf16 give too few detections for a steady median."""
from __future__ import annotations

import os
import time

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SMALL_INFER = {"config": {"RPN": {"NUM_POINTS": 8192, "SA_CONFIG": {
    "NPOINTS": [1024, 256, 64, 16]}}, "TPU": {"COMPUTE_DTYPE": "float32"}},
    "batch": 4, "n_batches": 1,
    "points_per_scene": 12000, "warmup": 1, "check_batches": 1,
    "trace_start": 1, "trace_iters": 2}
SMALL_TRAIN = {"batch": 8, "database": 12, "aug_copies": 2, "warmup": 1,
               "trace_start": 1, "trace_iters": 2}


def small_run(workload: str, seed: int = 2**31 + 11, seconds: float = 2.0,
              trace: bool = False, **over) -> dict:
    """run_cell on the CPU at a small size; `over` adds to the overrides
    (`config` is merged into the small configuration)."""
    cell = harness.load_cell(ROOT, workload)
    small = dict(SMALL_TRAIN if cell["traffic_file"]["driver"]
                 == "train_loop" else SMALL_INFER)
    cfg = dict(small.get("config", {}))
    cfg.update(over.pop("config", {}))
    small.update(over)
    if cfg:
        small["config"] = cfg
    return harness.run_cell(cell, seed=seed, seconds=seconds, trace=trace,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=small)
