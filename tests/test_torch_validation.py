"""In-training validation of the port against the JAX package, and the
Trainer's validation loop.

- eval_metrics: the three metric functions on the same inputs (equal;
  IoU-based errors within 1e-5).
- Validator: both packages' Validators on the same fitted weights and the
  same EVAL batches. Stage 1: the vote metrics are equal or differ by at
  most one vote a scene, i.e. |diff| <= mean over scenes of 1 / (votes - 1)
  for the precision and 1 / gts for the recall (counts from the JAX
  outputs); stage 2 (rcnn, ioun): recalls equal, IoU means and the IoU
  error within 1e-4.
- Read-only: on the CPU the loss histories and the final weights of
  Trainer.train_steps with a val_fn every step are bit-equal to those
  without one (stage 1 with dropout on, and RCNN), and the generator state
  and every parameter and BN buffer are bit-equal across each validation.
- The eval cadence, the per-eval and best checkpoints (readable by
  restore_train_state and load_part_checkpoint) and scalars.jsonl.
"""
import json
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (jax_detector, rpn_cfg, rpn_flat_weights,
                                stage2_cfg, stage2_flat_weights,
                                torch_detector, torch_stage2_model)
from ws3d_tpu.training import eval_metrics as jm
from ws3d_tpu.training.validation import Validator as JaxValidator
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets import (BoxPlaceDataset, RPNDataset,
                                     SyntheticKitti,
                                     synthetic_proposal_database)
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.training import (Trainer, Validator,
                                     load_part_checkpoint, make_val_fn,
                                     restore_train_state)
from ws3d_tpu_torch.training import eval_metrics as tm
from ws3d_tpu_torch.weights import load_flat


def _boxes(rng, P, spread=1.0):
    b = np.zeros((P, 7), np.float32)
    b[:, [0, 2]] = rng.randn(P, 2) * spread
    b[:, 1] = 1.65
    b[:, 3:6] = np.array([1.5, 1.6, 3.9], np.float32) * (
        1 + rng.randn(P, 3) * 0.05)
    b[:, 6] = rng.uniform(-0.3, 0.3, P)
    return b


def test_eval_metrics_match():
    rng = np.random.RandomState(0)
    votes = (rng.randn(300, 3) * 8).astype(np.float32)
    scores = rng.rand(300).astype(np.float32)
    gts = (rng.randn(32, 3) * 8).astype(np.float32)
    for count in (0, 5, 32):
        for thresh in (0.3, 1.1):
            assert tm.rpn_vote_metrics(votes, scores, gts, count, thresh) \
                == jm.rpn_vote_metrics(votes, scores, gts, count, thresh)
    gt = _boxes(rng, 12)
    pred = np.concatenate([gt + rng.randn(12, 7).astype(np.float32) * 0.1,
                           _boxes(rng, 20)])
    pred[:, 3:6] = np.abs(pred[:, 3:6])
    for g, p in ((gt, pred), (gt, pred[:0]), (gt[:0], pred)):
        ref = jm.box_recall_metrics(p, g)
        got = tm.box_recall_metrics(p, g)
        assert got == ref
    assert jm.box_recall_metrics(pred, gt)["single_recall_0.7"] > 0
    pred_iou = rng.rand(12).astype(np.float32)
    ref = jm.iou_prediction_error(pred_iou, pred[:12], gt)
    got = tm.iou_prediction_error(pred_iou, pred[:12], gt)
    assert abs(got["iou_pred_mae"] - ref["iou_pred_mae"]) <= 1e-5
    assert tm.iou_prediction_error(pred_iou[:0], pred[:0], gt[:0]) == \
        {"iou_pred_mae": 0.0}


def _state(variables):
    return types.SimpleNamespace(params=variables["params"],
                                 batch_stats=variables.get("batch_stats",
                                                           {}))


def _eval_rpn_batches(n_points=4096):
    from ws3d_tpu.config import load_config as jax_config
    from ws3d_tpu.datasets import SyntheticKitti as JaxSynthetic
    from ws3d_tpu.datasets.rpn_dataset import RPNDataset as JaxRPNDataset
    src = JaxSynthetic(num_scenes=4, points_per_scene=20000, seed=1000)
    ds = JaxRPNDataset(src, jax_config(), mode="EVAL", npoints=n_points,
                       seed=0)
    return list(ds.batches(2, steps=2, shuffle=False))


def test_rpn_validator_matches_jax():
    jmodel, variables, jcfg = jax_detector()
    tmodel, tcfg = torch_detector()
    batches = _eval_rpn_batches()
    jv = JaxValidator(jmodel, jcfg, "rpn")
    ref = jv.run(_state(variables), batches)
    got = Validator(tcfg, "rpn").run(tmodel, batches)
    # per-scene counts of the JAX outputs for the one-vote allowance
    inv_votes, inv_gts = [], []
    for batch in batches:
        votes, scores = jv._fwd(variables["params"], variables["batch_stats"],
                                batch["pts_input"])
        for b in range(votes.shape[0]):
            m = jm.rpn_vote_metrics(np.asarray(votes[b]),
                                    np.asarray(scores[b]),
                                    batch["gt_centers"][b],
                                    int(batch["gt_count"][b]),
                                    jcfg.RPN.SCORE_THRESH)
            if m["num_gt"]:
                inv_votes.append(1.0 / max(m["num_votes"] - 1, 1))
                inv_gts.append(1.0 / m["num_gt"])
    assert len(inv_gts) == 4 and ref["vote_precision"] > 0 \
        and ref["gt_recall"] > 0
    assert set(got) == set(ref)
    assert abs(got["vote_precision"] - ref["vote_precision"]) \
        <= np.mean(inv_votes)
    assert abs(got["gt_recall"] - ref["gt_recall"]) <= np.mean(inv_gts)
    # the port's own EVAL loader gives the same metrics
    src = SyntheticKitti(num_scenes=4, points_per_scene=20000, seed=1000)
    own = RPNDataset(src, tcfg, mode="EVAL", npoints=4096, seed=0)
    assert Validator(tcfg, "rpn").run(tmodel, own.batches(2)) == got


@pytest.mark.parametrize("stage", ["rcnn", "ioun"])
def test_rcnn_validator_matches_jax(stage):
    from flax.traverse_util import flatten_dict, unflatten_dict
    from ws3d_tpu.config import load_config as jax_config
    from ws3d_tpu.datasets.boxplace_dataset import (
        BoxPlaceDataset as JaxBoxPlace, synthetic_proposal_database as jdb)
    from ws3d_tpu.models import build_model as jax_build
    from ws3d_tpu.models import init_model
    jcfg = stage2_cfg(jax_config, stage)
    jmodel = jax_build(jcfg)
    variables = init_model(jmodel, jcfg, jax.random.PRNGKey(0))
    flat = stage2_flat_weights(stage == "ioun")
    f = flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    params = unflatten_dict({k: jnp.asarray(flat["params/" + "/".join(k)])
                             for k in f})
    ds = JaxBoxPlace(jdb(num=24, seed=4, crop_points=128), jcfg, mode="EVAL",
                     npoints=128, seed=0)
    batches = list(ds.batches(8, steps=3, shuffle=False))
    ref = JaxValidator(jmodel, jcfg, stage).run(
        types.SimpleNamespace(params=params, batch_stats={}), batches)
    tmodel, tcfg = torch_stage2_model(stage)
    got = Validator(tcfg, stage).run(tmodel, batches)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if "recall" in k or k == "score":
            assert got[k] == v, (k, got[k], v)
        else:
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
    assert ref["iou_mean"] > 0
    # the port's own EVAL loader gives the same crops
    tds = BoxPlaceDataset(synthetic_proposal_database(num=24, seed=4,
                                                      crop_points=128),
                          tcfg, mode="EVAL", npoints=128, seed=0)
    assert Validator(tcfg, stage).run(
        tmodel, tds.batches(8, steps=3, shuffle=False)) == got


def _rpn_setup(dropout: bool = True):
    cfg = rpn_cfg(load_config)
    if dropout:
        cfg.RPN.DP_RATIO = 0.5
    model = build_model(cfg, device="cpu")
    load_flat(model, rpn_flat_weights())
    src = SyntheticKitti(num_scenes=4, points_per_scene=20000, seed=3)
    train = list(RPNDataset(src, cfg, mode="TRAIN", npoints=2048,
                            seed=0).batches(2, steps=3, shuffle=True))
    vsrc = SyntheticKitti(num_scenes=2, points_per_scene=20000, seed=1000)
    val_ds = RPNDataset(vsrc, cfg, mode="EVAL", npoints=2048, seed=0)
    return cfg, model, train, val_ds


def _stage2_setup():
    model, cfg = torch_stage2_model("rcnn")
    db = synthetic_proposal_database(num=24, seed=4, crop_points=128)
    train = list(BoxPlaceDataset(db[:16], cfg, mode="TRAIN", npoints=128,
                                 seed=0).batches(8, steps=3))
    val_ds = BoxPlaceDataset(db[16:], cfg, mode="EVAL", npoints=128, seed=0)
    return cfg, model, train, val_ds


def _snapshot(trainer):
    return ([trainer.generator.get_state()]
            + [v.clone() for v in trainer.model.state_dict().values()])


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("stage", ["rpn", "rcnn"])
def test_validation_leaves_training_bit_equal(stage, tmp_path):
    runs = []
    for with_val in (False, True):
        cfg, model, train, val_ds = (_rpn_setup() if stage == "rpn"
                                     else _stage2_setup())
        trainer = Trainer(model, cfg, total_steps=3, stage=stage, seed=0,
                          log_fn=lambda s: None)
        val_fn, checks = None, []
        if with_val:
            inner = make_val_fn(cfg, stage,
                                lambda: val_ds.batches(2, steps=1))

            def val_fn(m, inner=inner, trainer=trainer, checks=checks):
                before = _snapshot(trainer)
                out = inner(m)
                checks.append(_same(before, _snapshot(trainer)))
                return out
        hist = trainer.train_steps(train, total_steps=3, log_every=1,
                                   prefetch_size=0, val_fn=val_fn,
                                   val_every=1, ckpt_dir=str(tmp_path))
        if with_val:
            assert checks == [True, True, True]
        runs.append((hist, {k: v.clone()
                            for k, v in model.state_dict().items()}))
    (h0, s0), (h1, s1) = runs
    assert len(h0) == 3 and h0 == h1
    assert all(math.isfinite(h["loss"]) for h in h0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_cadence_checkpoints_and_scalars(tmp_path):
    cfg, model, train, _ = _rpn_setup(dropout=False)
    scores = iter([0.2, 0.5, 0.3])
    seen, weights = [], []

    def val_fn(m):
        seen.append(trainer.step)
        weights.append({k: v.clone() for k, v in m.state_dict().items()})
        return {"score": next(scores), "gt_recall": 0.1}

    trainer = Trainer(model, cfg, total_steps=3, seed=0,
                      log_fn=lambda s: None, tb_dir=str(tmp_path / "tb"))
    trainer.train_steps(train * 2, total_steps=5, log_every=2,
                        prefetch_size=0, ckpt_dir=str(tmp_path),
                        val_fn=val_fn, val_every=2)
    # after steps 1 and 3 (every 2) and the last one, 4
    assert seen == [2, 4, 5]
    assert trainer.best_val == {"step": 3, "score": 0.5, "gt_recall": 0.1}
    assert trainer.writer is None
    for k in (1, 2, 3):
        assert (tmp_path / f"rpn_ckpt_e{k}.pt").exists()
    best = torch.load(tmp_path / "rpn_ckpt_best.pt", weights_only=True)
    e2 = torch.load(tmp_path / "rpn_ckpt_e2.pt", weights_only=True)
    assert best["step"] == e2["step"] == 4
    for k, v in weights[1].items():
        assert torch.equal(best["model"][k], v), k
    fresh = build_model(cfg, device="cpu", seed=1)
    opt = Trainer(fresh, cfg, total_steps=3, log_fn=lambda s: None).optimizer
    assert restore_train_state(str(tmp_path / "rpn_ckpt_best.pt"), fresh,
                               opt) == 4
    assert load_part_checkpoint(fresh, str(tmp_path / "rpn_ckpt_e3.pt"),
                                subtrees=("rpn",)) == len(weights[2])
    recs = [json.loads(line) for line in
            open(tmp_path / "tb" / "scalars.jsonl")]
    steps = [r["step"] for r in recs if "loss" in r]
    vals = [(r["step"], r["val/score"]) for r in recs if "val/score" in r]
    assert steps == [0, 2, 4]
    assert vals == [(1, 0.2), (3, 0.5), (4, 0.3)]


def test_default_cadence():
    cfg, model, train, _ = _rpn_setup(dropout=False)
    trainer = Trainer(model, cfg, total_steps=3, seed=0,
                      log_fn=lambda s: None)
    seen = []
    trainer.train_steps(train, total_steps=3, prefetch_size=0,
                        val_fn=lambda m: seen.append(trainer.step) or {})
    # max(3 // 20, 1) = 1: every step; no ckpt_dir, so no checkpoint and
    # no best
    assert seen == [1, 2, 3] and trainer.best_val is None
