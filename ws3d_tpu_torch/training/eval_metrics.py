"""Training-time eval metrics (port of ws3d_tpu/training/eval_metrics.py):
the stage-1 vote precision / gt recall with a 1.4 m BEV centre match, the
stage-2 IoU recall with its one-to-one "single" recall, and the IOUN's
predicted-IoU error. Host NumPy over outputs already on the host; the IoUs
run through the port's ops on CPU tensors."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ws3d_tpu_torch.losses import pairwise_diag_iou3d
from ws3d_tpu_torch.ops.iou3d import boxes_iou3d


def rpn_vote_metrics(pred_centers: np.ndarray, scores_norm: np.ndarray,
                     gt_centers: np.ndarray, gt_count: int,
                     score_thresh: float = 0.3,
                     match_radius: float = 1.4) -> Dict[str, float]:
    """One scene: pred_centers (N, 3) decoded votes, scores_norm (N,),
    gt_centers (G, 3) padded with gt_count valid rows. A vote above
    score_thresh hits when a gt centre lies within match_radius in BEV
    (explicit differences); a gt is recalled when a vote hits it."""
    sel = scores_norm > score_thresh
    votes = pred_centers[sel]
    gts = gt_centers[:gt_count]
    if gts.shape[0] == 0:
        return {"vote_precision": 0.0, "gt_recall": 0.0,
                "num_votes": int(sel.sum()), "num_gt": 0}
    if votes.shape[0] == 0:
        return {"vote_precision": 0.0, "gt_recall": 0.0,
                "num_votes": 0, "num_gt": int(gts.shape[0])}
    d = np.sqrt((votes[:, None, 0] - gts[None, :, 0]) ** 2
                + (votes[:, None, 2] - gts[None, :, 2]) ** 2)
    return {"vote_precision": float((d < match_radius).any(axis=1).mean()),
            "gt_recall": float((d < match_radius).any(axis=0).mean()),
            "num_votes": int(votes.shape[0]),
            "num_gt": int(gts.shape[0])}


def box_recall_metrics(pred_boxes: np.ndarray, gt_boxes: np.ndarray,
                       thresholds=(0.5, 0.7)) -> Dict[str, float]:
    """recall_t: the share of gts some prediction overlaps by more than t
    in 3D IoU; single_recall_t: the same with each prediction matched to at
    most one gt, greedily in decreasing IoU."""
    out: Dict[str, float] = {}
    if gt_boxes.shape[0] == 0 or pred_boxes.shape[0] == 0:
        for t in thresholds:
            out[f"recall_{t}"] = 0.0
            out[f"single_recall_{t}"] = 0.0
        return out
    _, iou3d = boxes_iou3d(torch.from_numpy(np.asarray(pred_boxes,
                                                       np.float32)),
                           torch.from_numpy(np.asarray(gt_boxes,
                                                       np.float32)))
    iou3d = iou3d.numpy()                                  # (P, G)
    for t in thresholds:
        out[f"recall_{t}"] = float((iou3d.max(axis=0) > t).mean())
        m = iou3d.copy()
        hit = 0
        for _ in range(min(m.shape)):
            i, j = np.unravel_index(m.argmax(), m.shape)
            if m[i, j] <= t:
                break
            hit += 1
            m[i, :] = -1
            m[:, j] = -1
        out[f"single_recall_{t}"] = hit / iou3d.shape[1]
    return out


def iou_prediction_error(pred_iou: np.ndarray, pred_boxes: np.ndarray,
                         gt_boxes: np.ndarray) -> Dict[str, float]:
    """Mean |predicted IoU - iou(pred_boxes, gt_boxes)^2| over aligned
    rows."""
    if pred_boxes.shape[0] == 0:
        return {"iou_pred_mae": 0.0}
    true_iou = pairwise_diag_iou3d(
        torch.from_numpy(np.asarray(pred_boxes, np.float32)),
        torch.from_numpy(np.asarray(gt_boxes, np.float32))).numpy()
    return {"iou_pred_mae": float(np.abs(pred_iou.reshape(-1)
                                         - true_iou ** 2).mean())}
