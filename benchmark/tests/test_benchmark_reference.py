"""The plain reference against the port's plain path on the same inputs
and weights, and the check of outputs failing on the faults a cell can
have and on the lower-precision control, at sizes a test run holds (CPU),
plus the training control on the card."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.tests.helpers import ROOT, small_run

WEIGHTS = os.path.join(ROOT, "ws3d_tpu", "data", "bench_weights.npz")


def _infer_tree(dtype="float32"):
    cell = harness.load_cell(ROOT, "cascade_bf16_b1")
    tree = harness._merged(cell["config_file"]["config"], {
        "RPN": {"NUM_POINTS": 8192, "SA_CONFIG": {
            "NPOINTS": [1024, 256, 64, 16]}},
        "TPU": {"COMPUTE_DTYPE": dtype}})
    return cell, tree


def _scenes(tree, batch=2, seed=5):
    from benchmark.gen.scenes import scene_batches
    return scene_batches(seed, batch, 1, 8192, 12000, 6,
                         tree["PC_AREA_SCOPE"])[0]


def test_reference_agrees_with_the_port_inference():
    from benchmark.reference import compare
    from benchmark.reference.net import Net, load_npz
    from benchmark.reference.pipeline import kitti_rows, two_stage
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    from ws3d_tpu_torch.weights import load_npz as port_load
    _, tree = _infer_tree()
    cfg = load_config().merge(tree, strict=True)
    model = build_model(cfg, device="cpu")
    port_load(model, WEIGHTS)
    pts = torch.from_numpy(_scenes(tree))
    port = make_two_stage_fn(model, cfg)(pts)
    ref = two_stage(Net(load_npz(WEIGHTS, "cpu"), tree), tree, pts)
    assert torch.equal(port["proposal_valid"], ref["proposal_valid"])
    assert torch.allclose(port["centers"], ref["centers"], atol=1e-4)
    assert int(port["n_live"]) == int(ref["n_live"])
    assert int(port["spilled"]) == int(ref["spilled"])
    assert torch.equal(port["keep"], ref["keep"])
    assert int(ref["keep"].sum()) > 0
    k = ref["keep"]
    assert torch.allclose(port["boxes"][k], ref["boxes"][k], atol=1e-3)
    assert torch.allclose(port["scores"][k], ref["scores"][k], atol=1e-3)
    rows = [kitti_rows(b, s, q, (375, 1242)) for b, s, q in zip(
        ref["boxes"].numpy(), ref["scores"].numpy(), ref["keep"].numpy())]
    nums = compare.detection_numbers(rows, rows)
    assert nums["det_unmatched"] == 0 and nums["det_centre_m"] == 0


def _rcnn_setup(batch=8, seed=3):
    from benchmark.gen.proposals import synthetic_proposal_database
    from benchmark.reference.loader import BoxPlaceDataset
    from benchmark.reference.train import Tree, initial_weights
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models.detector import PointRCNN
    cell = harness.load_cell(ROOT, "rcnn_train_800")
    tree = cell["config_file"]["config"]
    cfg = load_config().merge(tree, strict=True)
    model = PointRCNN(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    model.load_state_dict(initial_weights(shapes, seed, "cpu"))
    db = synthetic_proposal_database(num=12, seed=seed)
    host = next(BoxPlaceDataset(db, Tree(tree), "TRAIN", 512, seed=seed,
                                aug_copies=2).batches(batch))
    return tree, cfg, model, shapes, host


def test_reference_agrees_with_the_port_rcnn_step():
    from benchmark.drivers.train_loop import CHECK_KEYS
    from benchmark.reference.train import initial_weights, run_steps
    from ws3d_tpu_torch.training.optim import AdamOneCycle
    from ws3d_tpu_torch.training.trainer import (batch_to_device,
                                                 make_rcnn_train_step,
                                                 trainable_parameters)
    tree, cfg, model, shapes, host = _rcnn_setup()
    opt = AdamOneCycle(cfg, 1000, trainable_parameters(model,
                                                       "rcnn").items())
    step = make_rcnn_train_step(model, cfg, opt)
    model.train()
    aux = step(batch_to_device(host, "cpu", CHECK_KEYS),
               torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(np.ascontiguousarray(host[k]))
             for k in CHECK_KEYS}
    ref = run_steps(initial_weights(shapes, 3, "cpu"), tree, [batch], 1000)
    assert abs(float(aux["loss"]) - ref["losses"][0]) <= \
        1e-5 * abs(ref["losses"][0])
    for k, p in opt.params.items():
        assert torch.allclose(p.detach(), ref["params"][k], atol=1e-6,
                              rtol=1e-4), k


# -- the check fails on the faults a cell can have ----------------------
def _broken_fn(monkeypatch, edit):
    import ws3d_tpu_torch.pipeline as pipeline
    real = pipeline.make_two_stage_fn

    def make(model, cfg, *a, **kw):
        fn = real(model, cfg, *a, **kw)

        def broken(pts):
            return edit(fn, pts)
        return broken
    monkeypatch.setattr(pipeline, "make_two_stage_fn", make)


def test_inference_control_runs_are_correct():
    assert small_run("cascade_bf16_b1")["correct"]


def test_inference_fails_when_a_stage2_output_is_perturbed(monkeypatch):
    def edit(fn, pts):
        out = fn(pts)
        packed = out["packed"].clone()
        packed[..., 0] += 0.3                 # every box's x, by 0.3 m
        return dict(out, packed=packed)
    _broken_fn(monkeypatch, edit)
    r = small_run("cascade_bf16_b1")
    assert not r["correct"]
    assert r["checks"]["det_centre_median_m"]["value"] > \
        r["checks"]["det_centre_median_m"]["limit"]


def test_inference_fails_when_the_scores_are_altered(monkeypatch):
    def edit(fn, pts):
        out = fn(pts)
        packed = out["packed"].clone()
        packed[..., 7] += 0.05                # every predicted IoU score
        return dict(out, packed=packed)
    _broken_fn(monkeypatch, edit)
    r = small_run("cascade_bf16_b1")
    assert not r["correct"]
    assert r["checks"]["det_score_median"]["value"] > \
        r["checks"]["det_score_median"]["limit"]


def test_inference_fails_when_half_the_batch_is_left_out(monkeypatch):
    def edit(fn, pts):
        half = pts.shape[0] // 2
        out = fn(pts[:half])
        pad = {}
        for k, v in out.items():
            if v.dim() and v.shape[0] == half:
                v = torch.cat([v, torch.zeros((pts.shape[0] - half,)
                                              + v.shape[1:], dtype=v.dtype)])
            pad[k] = v
        return pad
    _broken_fn(monkeypatch, edit)
    r = small_run("cascade_bf16_b1", batch=4, n_batches=1, check_batches=1)
    assert not r["correct"]


@pytest.mark.parametrize("fault", ["stage2_half", "top_box_only"])
def test_inference_fails_when_stage2_leaves_out_detections(monkeypatch,
                                                           fault):
    """Stage 1 and the proposals as they should be, but stage 2 keeps no
    detection in every second scene, or only each scene's best one: the
    medians of the pairs cannot see it, det_unmatched has to."""
    import ws3d_tpu_torch.pipeline as pipeline
    from benchmark.calibrate import FAULTS
    monkeypatch.setattr(pipeline, "make_two_stage_fn",
                        FAULTS[fault](pipeline.make_two_stage_fn))
    r = small_run("cascade_bf16_b1")
    assert not r["correct"]
    checks = r["checks"]
    assert checks["det_unmatched"]["value"] > checks["det_unmatched"][
        "limit"]
    for k in ("det_centre_median_m", "det_score_median",
              "proposal_unmatched_q75"):
        assert checks[k]["value"] <= checks[k]["limit"], k


def _broken_trainer(monkeypatch, edit):
    import ws3d_tpu_torch.training.trainer as trainer_mod
    real = trainer_mod.Trainer

    class Broken(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            edit(self)
    monkeypatch.setattr(trainer_mod, "Trainer", Broken)


def test_training_control_runs_are_correct():
    assert small_run("rcnn_train_800_prebuilt")["correct"]


def test_training_fails_when_a_step_leaves_the_state_unchanged(monkeypatch):
    def edit(t):
        def step(grads):
            t.optimizer.count += 1
        t.optimizer.step = step
    _broken_trainer(monkeypatch, edit)
    r = small_run("rcnn_train_800")
    assert not r["correct"]
    assert r["checks"]["change_gap"]["value"] >= 0.99


def test_training_fails_when_half_the_batch_is_left_out(monkeypatch):
    def edit(t):
        real = t._step_batch

        def half(batch):
            out = real(batch)
            return {k: v[:v.shape[0] // 2] for k, v in out.items()}
        t._step_batch = half
    _broken_trainer(monkeypatch, edit)
    r = small_run("rcnn_train_800")
    assert not r["correct"]


def test_training_fails_when_the_loader_alters_a_batch(monkeypatch):
    import ws3d_tpu_torch.datasets.boxplace_dataset as bp
    real = bp.BoxPlaceDataset.batches

    def batches(self, *a, **kw):
        for b in real(self, *a, **kw):
            b = dict(b)
            b["cur_box_point"] = b["cur_box_point"] + np.float32(0.01)
            yield b
    monkeypatch.setattr(bp.BoxPlaceDataset, "batches", batches)
    r = small_run("rcnn_train_800")
    assert not r["correct"]
    assert r["checks"]["batch_mismatch"]["value"] > 0


# -- the lower-precision controls ----------------------------------------
def test_fp8_control_fails_the_inference_check():
    """The reference with float8 e4m3 products in the program's place, at
    the test's size, against the float32 reference."""
    from benchmark.drivers import infer_loop
    from benchmark.reference.compare import verdict
    from benchmark.reference.net import Net, fp8, load_npz
    cell, tree = _infer_tree("bfloat16")
    bufs = [_scenes(tree, batch=1, seed=s) for s in range(4)]
    params = load_npz(WEIGHTS, "cpu")
    ref = infer_loop.reference_side(Net(params, tree), tree, "cpu", bufs,
                                    range(4))
    low = infer_loop.reference_side(Net(params, tree, fp8), tree, "cpu",
                                    bufs, range(4))
    nums = infer_loop.numbers(low, ref, range(4))
    assert not verdict(nums, cell["traffic_file"]["limits"])["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3000000351, 3000000352, 3000000353,
                                  3000000354] + list(range(2200000201,
                                                           2200000215)))
def test_tf32_control_and_half_batch_fail_the_training_check(cuda_device,
                                                             seed):
    """The reference's steps with TF32 products in the program's place,
    and with half of each batch left out, on the card at the cell's size,
    against the float32 reference: each fails the check."""
    from benchmark.calibrate import training_control
    from benchmark.reference.compare import verdict
    cell = harness.load_cell(ROOT, "rcnn_train_800")
    got = training_control(cell, seed, cuda_device)
    limits = cell["traffic_file"]["limits"]
    assert not verdict(got["tf32"], limits)["correct"]
    assert not verdict(got["half_batch"], limits)["correct"]
