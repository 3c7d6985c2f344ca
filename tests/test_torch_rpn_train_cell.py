"""The stage-1 training cells of the benchmark (rpn_train_25 and
rpn_train_25_prebuilt) at a small size on the CPU: the port's TRAIN loader
with the GT-database augmentation against the benchmark's own copy
(benchmark/reference/rpn_loader.py), a stage-1 Trainer step against the
plain reference step (benchmark/reference/rpn_train.py), the cell's driver
with its check of outputs sound and with faults planted in the timed path,
the loader's spans and counter, and the readers that read them."""
from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import calibrate_rpn, harness
from benchmark.gen.weak_scenes import HeldScenes
from benchmark.reference import rpn_loader
from benchmark.reference.rpn_train import (INPUTS, rpn_initial_weights,
                                           run_steps, split)
from benchmark.reference.train import norms
from benchmark.roofline import stage1_counts
from ws3d_tpu_torch.datasets import gt_database as gt_db
from ws3d_tpu_torch.datasets import rpn_dataset
from ws3d_tpu_torch.datasets.gt_database import build_gt_database
from ws3d_tpu_torch.datasets.rpn_dataset import RPNDataset
from ws3d_tpu_torch.models.detector import PointRCNN
from ws3d_tpu_torch.training.trainer import Trainer
from ws3d_tpu_torch.utils.profiling import TRACE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "rpn_train_25_prebuilt"
# a few scenes of 1,024 points through a narrow SA configuration
SMALL_CONFIG = {"RPN": {"NUM_POINTS": 1024, "SA_CONFIG": {
    "NPOINTS": [256, 64, 16, 4],
    "MLPS": [[[8, 8, 16], [8, 8, 16]], [[16, 16, 32], [16, 16, 32]],
             [[32, 32, 32], [32, 32, 32]], [[32, 32, 64], [32, 32, 64]]]},
    "FP_MLPS": [[32, 32], [32, 32], [64, 64], [64, 64]],
    "CLS_FC": [32], "REG_FC": [32]}}
SMALL = {"batch": 2, "scenes": 6, "weakly_num": 6, "points_per_scene": 3000,
         "warmup": 1, "trace_start": 1, "trace_iters": 4}
SEED = 2**31 + 11
KEYS = ("pts_input", "rpn_cls_label", "rpn_reg_label", "gt_boxes3d",
        "gt_centers", "gt_count")


def small_cell():
    cell = harness.load_cell(ROOT, CELL)
    tree = harness._merged(cell["config_file"]["config"], SMALL_CONFIG)
    return dict(cell, config_file=dict(cell["config_file"], config=tree))


def small_cfg():
    return harness.program_config(small_cell())


@pytest.fixture
def kernel_wrappers(monkeypatch):
    """The driver wraps these module globals for its spans: each test
    gets them back as they were."""
    import ws3d_tpu_torch.ops.ball_query as bq
    import ws3d_tpu_torch.ops.fused_sa as fsa
    import ws3d_tpu_torch.ops.interpolate as interp
    import ws3d_tpu_torch.ops.sampling as smp
    for mod, name in ((torch.autograd, "grad"), (bq, "ball_query_multi_cuda"),
                      (fsa, "fused_sa_cuda"), (interp, "three_nn_cuda"),
                      (smp, "fps_cuda")):
        monkeypatch.setattr(mod, name, getattr(mod, name))


def small_run(trace: bool = False, workload: str = CELL) -> dict:
    over = dict(SMALL, config=SMALL_CONFIG)
    return harness.run_cell(harness.load_cell(ROOT, workload), seed=SEED,
                            seconds=1.0, trace=trace,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=over)


def program_loader(scenes, cfg, seed):
    weak = RPNDataset(scenes, cfg, mode="TRAIN", weakly_num=6, seed=seed)
    db = build_gt_database(scenes, weak.sample_ids)
    return RPNDataset(scenes, cfg, mode="TRAIN", weakly_num=6, seed=seed,
                      gt_database=db)


def test_loader_batches_equal_the_reference_loader():
    cfg = small_cfg()
    tree = small_cell()["config_file"]["config"]
    scenes = HeldScenes(6, seed=5, points_per_scene=3000)
    ds = program_loader(scenes, cfg, seed=17)
    ref = rpn_loader.RPNTrainLoader(scenes, tree, 6, seed=17)
    assert len(ds.gt_database[0]) == len(ref.database[0]) > 0
    assert len(ds.gt_database[1]) == len(ref.database[1])
    mine, theirs = ds.batches(2, shuffle=True), ref.batches(2)
    pasted = 0
    for _ in range(3):          # the second pass starts a new permutation
        a, b = next(mine), next(theirs)
        for k in KEYS:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        pasted += int(b["pasted"].sum())
    assert pasted > 0


def test_trainer_step_agrees_with_the_reference_step():
    cfg = small_cfg()
    tree = small_cell()["config_file"]["config"]
    scenes = HeldScenes(6, seed=5, points_per_scene=3000)
    batches = list(program_loader(scenes, cfg, seed=17).batches(
        2, steps=2, shuffle=True))
    model = PointRCNN(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(rpn_initial_weights(shapes, 3, "cpu"))
    model.train()
    trainer = Trainer(model, cfg, 8000, stage="rpn", seed=29,
                      log_fn=lambda s: None)
    hist = trainer.train_steps(iter(batches), 2, log_every=1,
                               prefetch_size=0)
    state = rpn_initial_weights(shapes, 3, "cpu")
    p0 = {k: v.clone() for k, v in split(state)[0].items()}
    ref = run_steps(state, tree, [{k: torch.from_numpy(b[k]) for k in INPUTS}
                                  for b in batches], 8000, dropout_seed=29)
    # the same float32 operations on the CPU in another grouping (the
    # port's plain ball query and interpolation, its BatchNorm's
    # torch.var): the losses agree to a few ulps of their ~6
    for got, want in zip([h["loss"] for h in hist], ref["losses"]):
        assert abs(got - want) <= 1e-5 * abs(want)
    # every parameter moved, by the reference's change to within 1e-3 of
    # the larger of its own change and the median leaf's: two Adam steps
    # divide each gradient by its own root mean square, so a rounding of
    # a near-zero gradient moves an update by up to ~1e-4 of the leaf
    got = {k: p.detach() - p0[k] for k, p in trainer.optimizer.params.items()}
    want = {k: ref["params"][k] - p0[k] for k in p0}
    g, w = norms(got), norms(want)
    med = float(np.median(list(w.values())))
    assert set(g) == set(w)
    assert all(v > 0 for v in w.values())
    assert max(abs(g[k] - w[k]) / max(w[k], med) for k in w) <= 1e-3
    # BatchNorm's running statistics moved as the reference's
    bn = {k: v for k, v in model.state_dict().items()
          if k.endswith((".mean", ".var"))}
    assert bn and all(torch.allclose(v, state[k], rtol=1e-4, atol=1e-6)
                      for k, v in bn.items())


def test_sound_run_is_correct_and_prints_the_contract_keys(kernel_wrappers,
                                                           capsys):
    result = small_run()
    harness.emit(result)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert last["correct"], last["checks"]
    assert set(last["metrics"]) == {"prebuilt_step_ms", "setup_s"}
    assert last["checks"]["batch_mismatch"]["value"] == 0.0


def _gt_aug_draw(patch):
    def apply(pts, inten, boxes, easy, hard, rng, **kw):
        rng.rand()                           # one draw more than the loader
        return gt_db.apply_gt_aug(pts, inten, boxes, easy, hard, rng, **kw)
    patch(rpn_dataset, "apply_gt_aug", apply)


FAULTS = {"half_batch": (calibrate_rpn.FAULTS["half_batch"], "grad_gap"),
          "bn_eval": (calibrate_rpn.FAULTS["bn_eval"], "grad_median_gap"),
          "gt_aug_draw": (_gt_aug_draw, "batch_mismatch")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_check(fault, kernel_wrappers, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch.setattr)
    result = small_run()
    assert not result["correct"]
    c = result["checks"][number]
    assert c["value"] > c["limit"], (number, c)


def test_traced_run_reports_the_new_metrics(kernel_wrappers):
    result = small_run(trace=True, workload="rpn_train_25")
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    for name in ("rpn.loader.sample_ms", "rpn.gt_aug.host_ms",
                 "rpn.labels.host_ms", "rpn.gt_aug.pasted",
                 "rpn.loader.batch_ms", "rpn.step.host_ms"):
        assert got[name] > 0, name
    assert got["rpn.gt_aug.host_ms"] < got["rpn.loader.sample_ms"]
    assert got["rpn.labels.host_ms"] < got["rpn.loader.sample_ms"]


def test_loader_spans_and_counter_record_only_while_profiled():
    cfg = small_cfg()
    scenes = HeldScenes(6, seed=5, points_per_scene=3000)
    ds = program_loader(scenes, cfg, seed=17)
    with profile(activities=[ProfilerActivity.CPU]):
        pass                                 # an empty last recording
    next(ds.batches(2, shuffle=True))
    assert TRACE.totals() == {"spans": {}, "counters": {}}
    ds = program_loader(scenes, cfg, seed=17)
    ref = rpn_loader.RPNTrainLoader(scenes, small_cell()["config_file"]
                                    ["config"], 6, seed=17)
    with profile(activities=[ProfilerActivity.CPU]):
        next(ds.batches(2, shuffle=True))
    tot = TRACE.totals()
    assert {k: v["calls"] for k, v in tot["spans"].items()} == {
        "loader.batch": 1, "loader.sample": 2, "loader.gt_aug": 2,
        "loader.labels": 2}
    assert tot["counters"] == {
        "loader.gt_pasted": int(next(ref.batches(2))["pasted"].sum())}


READERS = ("gt_aug.host_ms", "labels.host_ms", "gt_aug.pasted",
           "sa.device_ms", "fp.device_ms", "ball_query_roofline",
           "three_nn_roofline")


@pytest.mark.parametrize("reader", READERS)
def test_new_readers_read_none_without_their_spans(reader):
    with profile(activities=[ProfilerActivity.CPU]):
        pass                                 # no span, no counter
    rec = {"iters": 2, "device_s": {"step": 0.1}, "calls": {},
           "host_s": {}, "window_s": 1.0, "busy_s": 0.5}
    assert harness.read_metric("rpnpre." + reader, rec) is None


def test_search_counts_are_lower_bounds_of_the_dense_search():
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((2, 300, 3), generator=g) * 4
    order = torch.argsort(xyz[..., 2], dim=1)
    xyz = torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3))
    new = xyz[:, ::10].contiguous()
    c = stage1_counts.ball_query_counts([0.5, 1.0], [8, 16], xyz, new,
                                        block=7)
    assert c["bytes"] == 4 * (2 * 300 * 3 + 2 * 30 * 3 + 2 * 30 * 24)
    # (8 + 2 scales) operations a tested point, at most every point
    assert 0 < c["ops"] <= 10 * 2 * 30 * 300
    n = stage1_counts.three_nn_counts(xyz, new, prepass=False, block=64)
    assert n["bytes"] == 4 * (2 * 300 * 3 + 2 * 30 * 3 + 2 * 300 * 6)
    # each query tests at least its three nearest, at most every point
    assert 10 * 3 * 2 * 300 <= n["ops"] <= 10 * 2 * 300 * 30
    assert stage1_counts.bound_s(c) > 0 and stage1_counts.bound_s(n) > 0
