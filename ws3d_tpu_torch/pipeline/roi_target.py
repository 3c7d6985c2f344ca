"""RoI target assignment, the legacy PointRCNN capability (port of
ws3d_tpu/pipeline/roi_target.py): sample a fixed RoI set per scene as fg /
hard bg / easy bg by 3-D IoU against the ground truth, with IoU-guided
jitter of the fg RoIs. Host NumPy with an explicit RandomState; the IoU
is the port's ops.iou3d.boxes_iou3d on CPU tensors.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ws3d_tpu_torch.ops.iou3d import boxes_iou3d


def _iou3d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return boxes_iou3d(torch.from_numpy(np.ascontiguousarray(a, np.float32)),
                       torch.from_numpy(np.ascontiguousarray(b, np.float32))
                       )[1].numpy()


def sample_rois(rois: np.ndarray, gt_boxes: np.ndarray,
                roi_per_image: int = 32, fg_ratio: float = 0.5,
                fg_thresh: float = 0.55, bg_thresh: float = 0.45,
                bg_thresh_lo: float = 0.05, hard_bg_ratio: float = 0.8,
                rng: Optional[np.random.RandomState] = None
                ) -> Dict[str, np.ndarray]:
    """rois (R, 7), gt_boxes (G, 7) -> dict(rois (S, 7), gt_of_rois (S, 7),
    max_overlaps (S,), is_fg (S,)), S = roi_per_image: fg IoU >=
    fg_thresh, hard bg in [bg_thresh_lo, bg_thresh), easy bg below
    bg_thresh_lo, hard:easy = hard_bg_ratio."""
    rng = rng or np.random.RandomState(0)
    S = roi_per_image
    if gt_boxes.shape[0] == 0 or rois.shape[0] == 0:
        z = np.zeros((S, 7), np.float32)
        return {"rois": z, "gt_of_rois": z.copy(),
                "max_overlaps": np.zeros(S, np.float32),
                "is_fg": np.zeros(S, bool)}
    iou3d = _iou3d(rois, gt_boxes)
    max_ov = iou3d.max(axis=1)
    gt_idx = iou3d.argmax(axis=1)

    fg_inds = np.where(max_ov >= fg_thresh)[0]
    hard_bg = np.where((max_ov >= bg_thresh_lo) & (max_ov < bg_thresh))[0]
    easy_bg = np.where(max_ov < bg_thresh_lo)[0]

    n_fg = min(int(np.round(S * fg_ratio)), len(fg_inds))
    n_bg = S - n_fg

    def pick(pool, n):
        if len(pool) == 0 or n <= 0:
            return np.zeros(0, np.int64)
        return rng.choice(pool, n, replace=len(pool) < n)

    fg_sel = pick(fg_inds, n_fg)
    n_hard = int(n_bg * hard_bg_ratio)
    hard_sel = pick(hard_bg if len(hard_bg) else easy_bg, n_hard)
    easy_sel = pick(easy_bg if len(easy_bg) else hard_bg, n_bg - len(hard_sel))
    sel = np.concatenate([fg_sel, hard_sel, easy_sel]).astype(np.int64)
    if len(sel) < S:          # every pool empty: repeat RoIs
        sel = np.concatenate([sel, pick(np.arange(rois.shape[0]),
                                        S - len(sel))])
    sel = sel[:S]
    return {"rois": rois[sel].astype(np.float32),
            "gt_of_rois": gt_boxes[gt_idx[sel]].astype(np.float32),
            "max_overlaps": max_ov[sel].astype(np.float32),
            "is_fg": max_ov[sel] >= fg_thresh}


def random_aug_box3d(box: np.ndarray, method: str = "multiple",
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """One jittered copy of a (7,) box per cfg.RCNN.REG_AUG_METHOD:
    'single' (±0.5 m, ±15 % scale, ±pi/12), 'multiple' (one of five
    range tiers) or 'normal' (additive Gaussian on x..l, uniform ry)."""
    rng = rng or np.random.RandomState(0)
    if method == "single":
        pos = rng.rand(3) - 0.5
        scale = (rng.rand(3) - 0.5) / (0.5 / 0.15) + 1.0
        rot = (rng.rand(1) - 0.5) / (0.5 / (np.pi / 12))
    elif method == "multiple":
        tiers = [[0.2, 0.1, np.pi / 12], [0.3, 0.15, np.pi / 12],
                 [0.5, 0.15, np.pi / 9], [0.8, 0.15, np.pi / 6],
                 [1.0, 0.15, np.pi / 3]]
        t = tiers[rng.randint(len(tiers))]
        pos = (rng.rand(3) - 0.5) / 0.5 * t[0]
        scale = (rng.rand(3) - 0.5) / 0.5 * t[1] + 1.0
        rot = (rng.rand(1) - 0.5) / 0.5 * t[2]
    elif method == "normal":
        shift = np.array([rng.normal(0, 0.3), rng.normal(0, 0.2),
                          rng.normal(0, 0.3), rng.normal(0, 0.25),
                          rng.normal(0, 0.15), rng.normal(0, 0.5)])
        ry = (rng.rand() - 0.5) / 0.5 * np.pi / 12
        return np.concatenate([box[0:6] + shift, [box[6] + ry]]).astype(
            np.float32)
    else:
        raise ValueError(f"unknown REG_AUG_METHOD {method!r}")
    return np.concatenate([box[0:3] + pos, box[3:6] * scale,
                           box[6:7] + rot]).astype(np.float32)


def aug_roi_by_noise(roi: np.ndarray, gt: np.ndarray,
                     iou_thresh: float = 0.55, max_tries: int = 10,
                     method: Optional[str] = None,
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """Jitter the RoI until it overlaps its gt by at least iou_thresh
    (max_tries draws, else the RoI unchanged). `method` picks a
    REG_AUG_METHOD noise model; None the Gaussian jitter."""
    rng = rng or np.random.RandomState(0)
    for _ in range(max_tries):
        if method is not None:
            cand = random_aug_box3d(roi, method=method, rng=rng)
        else:
            cand = roi.copy()
            cand[0:3] += rng.normal(0, 0.2, 3)
            cand[3:6] *= 1.0 + rng.normal(0, 0.05, 3)
            cand[6] += rng.uniform(-np.pi / 12, np.pi / 12)
        if float(_iou3d(cand[None], gt[None])[0, 0]) >= iou_thresh:
            return cand
    return roi.copy()


def sample_rois_cfg(rois: np.ndarray, gt_boxes: np.ndarray, cfg,
                    rng: Optional[np.random.RandomState] = None,
                    aug_fg: bool = True) -> Dict[str, np.ndarray]:
    """sample_rois from the cfg.RCNN sampling keys (ROI_PER_IMAGE,
    FG_RATIO, CLS_FG/BG_THRESH(_LO), HARD_BG_RATIO), then ROI_FG_AUG_TIMES
    jitter tries of each fg RoI with REG_AUG_METHOD at
    min(REG_FG_THRESH, CLS_FG_THRESH)."""
    rng = rng or np.random.RandomState(0)
    r = cfg.RCNN
    fg_thresh = min(float(r.REG_FG_THRESH), float(r.CLS_FG_THRESH))
    out = sample_rois(rois, gt_boxes, roi_per_image=int(r.ROI_PER_IMAGE),
                      fg_ratio=float(r.FG_RATIO), fg_thresh=fg_thresh,
                      bg_thresh=float(r.CLS_BG_THRESH),
                      bg_thresh_lo=float(r.CLS_BG_THRESH_LO),
                      hard_bg_ratio=float(r.HARD_BG_RATIO), rng=rng)
    aug_times = int(r.ROI_FG_AUG_TIMES)
    if aug_fg and aug_times > 0 and gt_boxes.shape[0] > 0:
        sampled = out["rois"]
        for i in np.where(out["is_fg"])[0]:
            sampled[i] = aug_roi_by_noise(
                sampled[i], out["gt_of_rois"][i], iou_thresh=fg_thresh,
                max_tries=aug_times, method=str(r.REG_AUG_METHOD), rng=rng)
    return out
