"""In-training validation (port of ws3d_tpu/training/validation.py).

A Validator runs the model's eval forward over a fresh iterator of EVAL
batches and returns a metric dict with a scalar `score` that the Trainer
uses to keep its best checkpoint:

- rpn: the vote precision and gt recall of training/eval_metrics
  (score = their sum);
- rcnn: the aligned 3D IoU of each foreground crop's box against its gt:
  mean, recall at 0.5 / 0.7 and the per-instance "single" recall (the best
  crop of each (sample_id, box_id)); score = recall_0.5 + recall_0.7;
- ioun: the same on the refined box, plus the refined recalls and the
  predicted-IoU error; score = refined_recall_0.5 + refined_recall_0.7.

The forward runs under torch.no_grad() with train=False on the model's
device, so it reads the BatchNorm running statistics and updates none, and
draws no random numbers (no dropout). Each batch's outputs come back to the
host in one copy.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch

from ws3d_tpu_torch.box_codec import decode_center
from ws3d_tpu_torch.losses import pairwise_diag_iou3d
from ws3d_tpu_torch.training.eval_metrics import rpn_vote_metrics
from ws3d_tpu_torch.training.trainer import batch_to_device, step_inputs


class Validator:
    """Stage-aware validation: run(model, batches) -> metric dict."""

    def __init__(self, cfg, stage: str = "rpn"):
        if stage not in ("rpn", "rcnn", "ioun"):
            raise ValueError(f"stage {stage!r}: rpn, rcnn or ioun")
        self.cfg = cfg
        self.stage = stage

    def run(self, model, batches: Iterable) -> Dict[str, float]:
        device = next(model.parameters()).device
        with torch.no_grad():
            if self.stage == "rpn":
                return self._run_rpn(model, batches, device)
            return self._run_rcnn(model, batches, device)

    def _run_rpn(self, model, batches, device) -> Dict[str, float]:
        rpn = self.cfg.RPN
        agg = {"vote_precision": [], "gt_recall": []}
        for batch in batches:
            out = model.rpn_forward(
                batch_to_device(batch, device, ("pts_input",)), train=False)
            votes = decode_center(out["backbone_xyz"], out["rpn_reg"],
                                  rpn.LOC_SCOPE, rpn.LOC_BIN_SIZE)
            scores = torch.sigmoid(out["rpn_cls"][..., 0])
            host = torch.cat([votes, scores[..., None]], -1).cpu().numpy()
            for b in range(host.shape[0]):
                m = rpn_vote_metrics(host[b, :, :3], host[b, :, 3],
                                     batch["gt_boxes3d"][b, :, :3],
                                     int(batch["gt_count"][b]),
                                     score_thresh=rpn.SCORE_THRESH)
                if m["num_gt"] > 0:
                    agg["vote_precision"].append(m["vote_precision"])
                    agg["gt_recall"].append(m["gt_recall"])
        out = {k: float(np.mean(v)) if v else 0.0 for k, v in agg.items()}
        out["score"] = out["vote_precision"] + out["gt_recall"]
        return out

    def _run_rcnn(self, model, batches, device) -> Dict[str, float]:
        is_ioun = self.stage == "ioun"
        ious, ious_ref, iou_err = [], [], []
        inst_best: Dict[tuple, float] = {}
        for batch in batches:
            out = model.rcnn_forward(
                batch_to_device(batch, device, step_inputs(self.stage, batch)),
                train=False)
            boxes = out["pred_boxes3d"].reshape(-1, 7)
            refined = out.get("refined_box", out["pred_boxes3d"])
            pred_iou = out.get("rcnn_iou", out["rcnn_cls"]).reshape(-1, 1)
            host = torch.cat([boxes, refined.reshape(-1, 7), pred_iou],
                             -1).cpu()
            fg = np.asarray(batch["cls"]).reshape(-1) > 0
            if not fg.any():
                continue
            fg_t = torch.from_numpy(fg)
            gt = torch.from_numpy(np.asarray(batch["gt_boxes"], np.float32)
                                  .reshape(-1, 7)[fg])
            iou = pairwise_diag_iou3d(host[fg_t, :7], gt).numpy()
            ious.extend(iou.tolist())
            iou_r = iou
            if is_ioun:
                iou_r = pairwise_diag_iou3d(host[fg_t, 7:14], gt).numpy()
                ious_ref.extend(iou_r.tolist())
                iou_err.extend(np.abs(host[fg_t, 14].numpy()
                                      - iou_r ** 2).tolist())
            sids = np.asarray(batch.get(
                "sample_id", np.zeros(fg.shape[0]))).reshape(-1)
            bids = np.asarray(batch.get(
                "box_id", np.arange(fg.shape[0]))).reshape(-1)
            for j, k in enumerate(np.where(fg)[0]):
                key = (int(sids[k]), int(bids[k]))
                inst_best[key] = max(inst_best.get(key, 0.0), float(iou_r[j]))

        ious = np.asarray(ious) if ious else np.zeros(1)
        out = {"iou_mean": float(ious.mean()),
               "recall_0.5": float((ious > 0.5).mean()),
               "recall_0.7": float((ious > 0.7).mean())}
        if inst_best:
            best = np.asarray(list(inst_best.values()))
            out["single_recall_0.5"] = float((best > 0.5).mean())
            out["single_recall_0.7"] = float((best > 0.7).mean())
        if is_ioun:
            ref = np.asarray(ious_ref)
            out["refined_recall_0.5"] = float((ref > 0.5).mean())
            out["refined_recall_0.7"] = float((ref > 0.7).mean())
            out["iou_pred_mae"] = float(np.mean(iou_err))
            out["score"] = (out["refined_recall_0.5"]
                            + out["refined_recall_0.7"])
        else:
            out["score"] = out["recall_0.5"] + out["recall_0.7"]
        return out


def make_val_fn(cfg, stage: str,
                batches_fn: Callable[[], Iterable]) -> Callable:
    """val_fn(model) -> metric dict over a fresh batches_fn() iterator, for
    Trainer.train_steps(val_fn=...)."""
    validator = Validator(cfg, stage)

    def val_fn(model) -> Dict[str, float]:
        return validator.run(model, batches_fn())

    return val_fn
