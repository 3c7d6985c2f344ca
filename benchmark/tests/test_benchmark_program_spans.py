"""The per-layer metrics read from the program's own spans and counters
(ws3d_tpu_torch.utils.profiling.TRACE): small traced CPU runs of the
batch-1 inference cell and of the loader's training cell report each of
theirs above 0, the sweeps take 576 host steps a batch (K 512 in the
proposal layer, 64 in finalize), and a second traced run in the same
process reads its own stretch, not the sum of the two."""
from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.helpers import ROOT, small_run

NEW = {"cascade_bf16_b1": ("scene.sweep.host_ms", "scene.sweep.steps",
                           "scene.compact.host_ms"),
       "rcnn_train_800": ("train.wait.host_ms", "train.loader.sample_ms",
                          "train.to_device.host_ms", "train.step.host_ms")}
# a stretch of 4 steps holds two whole trainer.step spans: the first and
# the last are cut by the recording's start and end
OVER = {"rcnn_train_800": {"trace_iters": 4}}
# A sum of two runs would double a reading per batch. Of those, the
# sweep's is steady on the CPU (576 steps of work a batch); the compaction
# there waits for no device and reads a millisecond of the host's noise.
# The training readings are per call, which a sum would not double: the
# equal calls of the two runs show that their spans do not add up.
PER_BATCH = {"scene.sweep.host_ms"}


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_runs_report_the_program_span_metrics(workload):
    from ws3d_tpu_torch.utils.profiling import TRACE
    cell = harness.load_cell(ROOT, workload)
    assert set(NEW[workload]) <= {m["name"] for m in cell["per_layer"]}
    runs, calls = [], []
    for seed in (2**31 + 21, 2**31 + 22):
        result = small_run(workload, seed=seed, trace=True,
                           **OVER.get(workload, {}))
        assert result["correct"], result["checks"]
        runs.append({k: v["value"] for k, v in result["metrics"].items()})
        # the spans of the main thread: the prefetch and writer threads'
        # run ahead or behind it by as many as they can
        calls.append({k: v["calls"] for k, v in
                      TRACE.totals()["spans"].items()
                      if not k.startswith(("loader.", "kitti_io."))})
    assert calls[0] == calls[1]           # a stretch's calls, not two
    for name in NEW[workload]:
        first, second = (r[name] for r in runs)
        assert first > 0 and second > 0, name
        if name in PER_BATCH:
            assert 0.5 * first <= second <= 2.0 * first, (name, first,
                                                          second)
    if workload == "cascade_bf16_b1":
        assert runs[0]["scene.sweep.steps"] == 576.0
        assert runs[1]["scene.sweep.steps"] == 576.0
        # the sweeps lie inside rpn_propose and finalize_detections
        for r in runs:
            assert r["scene.sweep.host_ms"] <= r["scene.glue.host_ms"]
