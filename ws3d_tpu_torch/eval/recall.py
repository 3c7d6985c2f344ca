"""Cumulative ground-truth recall tally of the eval tools: per scene, the
3D IoU of the final kept boxes against the gt boxes; a gt counts as
recalled at threshold t when its best IoU exceeds t. Copy of
ws3d_tpu/eval/recall.py.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ws3d_tpu_torch.eval.kitti_ap import d3_box_overlap

THRESH_LIST = (0.1, 0.3, 0.5, 0.7, 0.9)


class RecallTally:
    def __init__(self, thresholds: Sequence[float] = THRESH_LIST):
        self.thresholds = tuple(thresholds)
        self.recalled = [0] * len(self.thresholds)
        self.total_gt = 0

    def update(self, pred_boxes: np.ndarray, gt_boxes: np.ndarray) -> None:
        """pred_boxes (P, 7), gt_boxes (G, 7): scene-frame, bottom-y."""
        g = gt_boxes.reshape(-1, 7)
        if g.shape[0] == 0:
            return
        self.total_gt += g.shape[0]
        p = pred_boxes.reshape(-1, 7)
        if p.shape[0] == 0:
            return
        # (x, y, z, h, w, l, ry) bottom-y -> camera layout [x,y,z,l,h,w,ry]
        cam = [0, 1, 2, 5, 3, 4, 6]
        iou3d = d3_box_overlap(p[:, cam].astype(np.float64),
                               g[:, cam].astype(np.float64))
        best = iou3d.max(axis=0)
        for i, t in enumerate(self.thresholds):
            self.recalled[i] += int((best > t).sum())

    def summary_lines(self):
        out = []
        for t, r in zip(self.thresholds, self.recalled):
            out.append("total bbox recall(thresh=%.3f): %d / %d = %f"
                       % (t, r, self.total_gt, r / max(self.total_gt, 1)))
        return out
