"""GT-instance database augmentation, scene copy-paste (port of
ws3d_tpu/datasets/gt_database.py).

build_gt_database harvests the points inside each Car/Van box of a set of
scenes into an easy and a hard database (HARD_POINT_THRESH points or
fewer: hard). apply_gt_aug pastes up to AUG_NUM instances into a training
scene at polar positions (theta in [pi/4, 3pi/4]; depth 3-35 m for the
first third, 35-70 m for the rest) that keep SPARSE_DISTANCE from every
box and earlier insert, clears the scene's points within CLEAR_RADIUS of
each insert, and subsamples the mimic-hard easy instances to
MIMIC_HARD_POINTS by FPS. Host NumPy; it draws from the caller's
RandomState in the JAX package's order, so both packages give the same
scenes for the same seed.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ws3d_tpu_torch.datasets.kitti_io import objs_to_boxes3d
from ws3d_tpu_torch.ops.boxes import points_in_rotated_boxes
from ws3d_tpu_torch.utils.sampling_np import greedy_furthest_point_sample

AUG_NUM = 15
SPARSE_DISTANCE = 8.0
CLEAR_RADIUS = 3.6
HARD_POINT_THRESH = 60
MIMIC_HARD_POINTS = 100


def build_gt_database(source, sample_ids, classes=("Car", "Van"),
                      min_points: int = 10) -> Tuple[List[Dict], List[Dict]]:
    """-> (easy_db, hard_db). An entry holds the instance's points with x/z
    relative to its box centre, their intensity, the box moved to the
    origin in x/z, and presampling_flag (more than HARD_POINT_THRESH points:
    an easy instance, a mimic-hard candidate). Instances with fewer than
    `min_points` points are dropped. The in-box test is
    ops.boxes.points_in_rotated_boxes in float32 on CPU tensors."""
    easy, hard = [], []
    for sid in sample_ids:
        scene = source.get_scene(sid)
        boxes = objs_to_boxes3d([o for o in scene.labels
                                 if o.cls_type in classes])
        if boxes.shape[0] == 0:
            continue
        pts = scene.pts_rect
        inten = scene.pts_intensity
        inb = points_in_rotated_boxes(
            torch.from_numpy(np.asarray(pts, np.float32)),
            torch.from_numpy(np.asarray(boxes, np.float32))).numpy()
        for k in range(boxes.shape[0]):
            m = inb[:, k]
            if m.sum() < min_points:
                continue
            p = pts[m].copy()
            p[:, 0] -= boxes[k, 0]
            p[:, 2] -= boxes[k, 2]
            box = boxes[k].copy()
            box[0] = box[2] = 0.0
            entry = {"points": p.astype(np.float32),
                     "intensity": inten[m].astype(np.float32),
                     "gt_box3d": box,
                     "presampling_flag": p.shape[0] > HARD_POINT_THRESH}
            (easy if entry["presampling_flag"] else hard).append(entry)
    return easy, hard


def apply_gt_aug(pts_rect: np.ndarray, intensity: np.ndarray,
                 gt_boxes3d: np.ndarray, easy_db: List[Dict],
                 hard_db: List[Dict], rng: np.random.RandomState,
                 aug_num: int = AUG_NUM):
    """Paste up to aug_num instances -> (pts, intensity, extra_boxes (E, 7)).

    The picks: a third hard (when there are hard entries), the rest easy,
    the first half of the easy ones mimic-hard."""
    if not easy_db:
        return pts_rect, intensity, np.zeros((0, 7), np.float32)
    n_hard = aug_num // 3 if hard_db else 0
    n_easy = aug_num - n_hard
    picks = ([hard_db[i] for i in rng.choice(len(hard_db), n_hard)]
             if n_hard else [])
    picks += [easy_db[i] for i in rng.choice(len(easy_db), n_easy)]
    mimic = set(range(n_hard, n_hard + n_easy // 2))

    theta = rng.uniform(0.25 * np.pi, 0.75 * np.pi, aug_num)
    depth = np.concatenate([
        rng.uniform(3.0, 35.0, aug_num - (aug_num * 2 // 3)),
        rng.uniform(35.0, 70.0, aug_num * 2 // 3)])
    centers = np.stack([np.cos(theta) * depth, np.zeros(aug_num),
                        np.sin(theta) * depth], axis=1)

    # the collision gate against the boxes and the inserts kept so far
    existing = (gt_boxes3d[:, [0, 2]] if gt_boxes3d.shape[0]
                else np.zeros((0, 2)))
    kept: List[int] = []
    for i in range(len(picks)):
        ref = (np.concatenate([existing, centers[kept][:, [0, 2]]])
               if kept or len(existing) else np.zeros((0, 2)))
        if ref.shape[0] == 0 or np.min(
                np.hypot(ref[:, 0] - centers[i, 0],
                         ref[:, 1] - centers[i, 2])) > SPARSE_DISTANCE:
            kept.append(i)
    if not kept:
        return pts_rect, intensity, np.zeros((0, 7), np.float32)

    ins_centers = centers[kept]
    d = np.hypot(pts_rect[:, None, 0] - ins_centers[None, :, 0],
                 pts_rect[:, None, 2] - ins_centers[None, :, 2]).min(axis=1)
    keep_mask = d > CLEAR_RADIUS
    pts_rect = pts_rect[keep_mask]
    intensity = intensity[keep_mask]

    extra_boxes, add_pts, add_int = [], [], []
    for j, i in enumerate(kept):
        entry = picks[i]
        p = entry["points"].copy()
        it = entry["intensity"].copy()
        if (i in mimic and entry.get("presampling_flag")
                and p.shape[0] > MIMIC_HARD_POINTS):
            sel = greedy_furthest_point_sample(p, MIMIC_HARD_POINTS)
            p, it = p[sel], it[sel]
        p[:, 0] += ins_centers[j, 0]
        p[:, 2] += ins_centers[j, 2]
        box = entry["gt_box3d"].copy()
        box[0], box[2] = ins_centers[j, 0], ins_centers[j, 2]
        add_pts.append(p)
        add_int.append(it.reshape(-1))
        extra_boxes.append(box)
    pts_rect = np.concatenate([pts_rect] + add_pts, axis=0)
    intensity = np.concatenate([intensity] + add_int, axis=0)
    return pts_rect, intensity, np.stack(extra_boxes).astype(np.float32)
