"""The stage-2 proposal database for the training cells: a frozen copy of
the port's synthetic_proposal_database (datasets/boxplace_dataset.py):
car-shaped crops near the proposal centre, in the record layout the
proposal-database tool writes (raw masks: prob_mask sigmoid scores in
[0, 1], gt_mask 0/1)."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from benchmark.gen.synthetic import CAR_MEAN_HWL, _car_surface_points


def synthetic_proposal_database(num: int = 64, seed: int = 0,
                                crop_points: int = 512,
                                fg_ratio: float = 0.7,
                                offset_std: float = 0.3) -> List[Dict]:
    """A stage-2 database without stage 1: car-shaped crops near the
    proposal centre in the record layout above (raw masks: prob_mask
    sigmoid scores in [0, 1], gt_mask 0/1). For tests and smoke training."""
    rng = np.random.RandomState(seed)
    db = []
    for i in range(num):
        fg = rng.rand() < fg_ratio
        if fg:
            hwl = CAR_MEAN_HWL * (1 + rng.randn(3) * 0.05)
            offset = rng.randn(2) * offset_std
            ry = rng.uniform(-math.pi, math.pi)
            box = np.array([offset[0], 1.65, offset[1], *hwl, ry], np.float32)
            n_car = min(rng.randint(80, 300), crop_points * 3 // 4)
            car_pts = _car_surface_points(rng, box, n_car)
        else:
            box = np.zeros(7, np.float32)
            n_car = 0
            car_pts = np.zeros((0, 3), np.float32)
        n_bg = crop_points - n_car
        bg = np.empty((n_bg, 3), np.float32)
        r = np.sqrt(rng.rand(n_bg)) * 4.0
        th = rng.rand(n_bg) * 2 * np.pi
        bg[:, 0] = r * np.cos(th)
        bg[:, 2] = r * np.sin(th)
        bg[:, 1] = 1.65 + rng.randn(n_bg) * 0.05
        pts = np.concatenate([car_pts, bg], axis=0)
        perm = rng.permutation(pts.shape[0])
        pts = pts[perm]
        is_car = (perm < n_car)
        prob_mask = np.where(is_car, 0.9, 0.1).astype(np.float32)
        prob_mask += rng.randn(crop_points).astype(np.float32) * 0.05
        prob_mask = np.clip(prob_mask, 0.0, 1.0)
        gt_mask = is_car.astype(np.float32)
        db.append({
            "sample_id": i, "box_id": 0,
            "center": np.zeros(3, np.float32),
            "foreground_flag": fg,
            "gt_boxes": box,
            "cur_box_point": pts,
            "cur_box_reflect": rng.rand(crop_points).astype(np.float32) - 0.5,
            "cur_prob_mask": prob_mask,
            "gt_mask": gt_mask,
        })
    return db
