"""Frozen copy of the stage-1 loader's TRAIN batches with the GT-database
copy-paste augmentation (the port's datasets/rpn_dataset.py and
datasets/gt_database.py, as PointRCNN's and WS3D's lib/datasets do it):
the same scenes, configuration and seed give the same batches, bit for
bit. It imports nothing of the port.

The GT database: the points inside each Car/Van box of the scenes' real
labels (in-box test in float32, faces included), x/z relative to the box
centre, easy above 60 points and hard otherwise, instances under 10 points
dropped. A sample draws from one RandomState in this order: the GT-aug
gate (GT_AUG_APPLY_PROB), then the augmentation's picks (a third hard,
the rest easy), polar positions (theta in [pi/4, 3pi/4], depth 3-35 m for
the first third, 35-70 m for the rest), kept where 8 m from every box and
earlier insert; the scene's points within 3.6 m of an insert are cleared
and the first half of the easy picks thinned to 100 points by greedy FPS.
Then the image-FOV and range crop, the near/far 16,384-point sample,
intensity - 0.5, the global augmentation (enable draws, rotation about y
within pi/18, scaling in [0.95, 1.05], x-flip at 0.5), a stable sort by z,
and the Gaussian labels around the weak centres (the nearest centre's
distance with y scaled by GAUSS_HEIGHT, less GAUSS_STATUS, in
exp(-d^2 / (2 GAUSS_COV)); reg targets (dx, 0, dz) within 4 m). Each pass
over the scenes starts with a permutation from the same stream.

Departures from the published loaders (each as the port has it, so that
the batches compare exactly): a fixed 15 inserts with a third hard (the
yaml's GT_EXTRA_NUM and GT_AUG_HARD_RATIO are not read), the first
MAX_GT boxes kept in gt_boxes3d while every box labels, and the sort by z
after the augmentation (the port's SORT_POINTS_Z).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from benchmark.gen.scenes import sample_npoints, valid_point_mask

MAX_GT = 32
AUG_NUM = 15
SPARSE_DISTANCE = 8.0
CLEAR_RADIUS = 3.6
HARD_POINT_THRESH = 60
MIMIC_HARD_POINTS = 100
VEHICLES = ("Car", "Van")


def boxes_of(objs) -> np.ndarray:
    """Car/Van label records -> (n, 7) float32 [x, y, z, h, w, l, ry]."""
    rows = [np.array([*o.pos, o.h, o.w, o.l, o.ry], np.float32)
            for o in objs if o.cls_type in VEHICLES]
    return np.stack(rows) if rows else np.zeros((0, 7), np.float32)


def in_boxes(pts: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(N, 3), (G, 7) bottom-y -> (N, G) bool, faces included, in float32."""
    p = torch.from_numpy(np.asarray(pts, np.float32))
    b = torch.from_numpy(np.asarray(boxes, np.float32))
    shift = p[:, None, :] - b[None, :, 0:3]
    h, w, l = b[:, 3], b[:, 4], b[:, 5]
    c, s = torch.cos(b[:, 6]), torch.sin(b[:, 6])
    x_loc = shift[..., 0] * c - shift[..., 2] * s
    z_loc = shift[..., 0] * s + shift[..., 2] * c
    return ((torch.abs(x_loc) <= l / 2.0) & (torch.abs(z_loc) <= w / 2.0)
            & (torch.abs(shift[..., 1] + h / 2.0) <= h / 2.0)).numpy()


def gt_database(scenes, sample_ids, min_points: int = 10
                ) -> Tuple[List[Dict], List[Dict]]:
    easy, hard = [], []
    for sid in sample_ids:
        scene = scenes.get_scene(sid)
        boxes = boxes_of(scene.labels)
        if boxes.shape[0] == 0:
            continue
        pts = scene.calib.lidar_to_rect(scene.pts_lidar[:, 0:3])
        inten = scene.pts_lidar[:, 3]
        inb = in_boxes(pts, boxes)
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
                     "box": box, "easy": p.shape[0] > HARD_POINT_THRESH}
            (easy if entry["easy"] else hard).append(entry)
    return easy, hard


def fps_host(points: np.ndarray, k: int) -> np.ndarray:
    """Greedy FPS from index 0, the lowest index on ties."""
    n = points.shape[0]
    k = min(k, n)
    out = np.empty(k, np.int64)
    out[0] = 0
    d2 = np.full(n, np.inf)
    last = 0
    for i in range(1, k):
        diff = points - points[last]
        d2 = np.minimum(d2, np.einsum("nd,nd->n", diff, diff))
        last = int(d2.argmax())
        out[i] = last
    return out


def paste(pts, inten, boxes, easy, hard, rng):
    """-> (pts, intensity, pasted boxes (E, 7))."""
    if not easy:
        return pts, inten, np.zeros((0, 7), np.float32)
    n_hard = AUG_NUM // 3 if hard else 0
    n_easy = AUG_NUM - n_hard
    picks = [hard[i] for i in rng.choice(len(hard), n_hard)] if n_hard \
        else []
    picks += [easy[i] for i in rng.choice(len(easy), n_easy)]
    mimic = range(n_hard, n_hard + n_easy // 2)
    theta = rng.uniform(0.25 * np.pi, 0.75 * np.pi, AUG_NUM)
    depth = np.concatenate([
        rng.uniform(3.0, 35.0, AUG_NUM - (AUG_NUM * 2 // 3)),
        rng.uniform(35.0, 70.0, AUG_NUM * 2 // 3)])
    centers = np.stack([np.cos(theta) * depth, np.zeros(AUG_NUM),
                        np.sin(theta) * depth], axis=1)
    taken = [boxes[:, [0, 2]]] if boxes.shape[0] else []
    kept = []
    for i in range(len(picks)):
        ref = np.concatenate(taken + [centers[kept][:, [0, 2]]]) \
            if taken or kept else np.zeros((0, 2))
        if ref.shape[0] == 0 or np.min(np.hypot(
                ref[:, 0] - centers[i, 0],
                ref[:, 1] - centers[i, 2])) > SPARSE_DISTANCE:
            kept.append(i)
    if not kept:
        return pts, inten, np.zeros((0, 7), np.float32)
    at = centers[kept]
    d = np.hypot(pts[:, None, 0] - at[None, :, 0],
                 pts[:, None, 2] - at[None, :, 2]).min(axis=1)
    clear = d > CLEAR_RADIUS
    new_pts, new_int, new_boxes = [pts[clear]], [inten[clear]], []
    for j, i in enumerate(kept):
        e = picks[i]
        p, it = e["points"].copy(), e["intensity"].copy()
        if i in mimic and e["easy"] and p.shape[0] > MIMIC_HARD_POINTS:
            sel = fps_host(p, MIMIC_HARD_POINTS)
            p, it = p[sel], it[sel]
        p[:, 0] += at[j, 0]
        p[:, 2] += at[j, 2]
        box = e["box"].copy()
        box[0], box[2] = at[j, 0], at[j, 2]
        new_pts.append(p)
        new_int.append(it.reshape(-1))
        new_boxes.append(box)
    return (np.concatenate(new_pts, axis=0),
            np.concatenate(new_int, axis=0),
            np.stack(new_boxes).astype(np.float32))


def _rotate(pc: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]], dtype=pc.dtype)
    pc[:, [0, 2]] = pc[:, [0, 2]] @ R
    return pc


def global_aug(pts, boxes, rng, rot_range, prob):
    enable = 1.0 - rng.rand(3)
    if enable[0] < prob[0]:
        angle = rng.uniform(-np.pi / rot_range, np.pi / rot_range)
        pts = _rotate(pts.copy(), angle)
        boxes = _rotate(boxes.copy(), angle)
    if enable[1] < prob[1]:
        scale = rng.uniform(0.95, 1.05)
        pts = pts * scale
        boxes = boxes.copy()
        boxes[:, 0:6] *= scale
    if enable[2] < prob[2]:
        pts, boxes = pts.copy(), boxes.copy()
        pts[:, 0] = -pts[:, 0]
        boxes[:, 0] = -boxes[:, 0]
    return pts, boxes


def gaussian_labels(pts, centers, height, status, cov):
    n = pts.shape[0]
    cls = np.zeros((n,), np.float32)
    reg = np.zeros((n, 3), np.float32)
    if centers.shape[0] == 0:
        return cls, reg
    dx = pts[:, 0:1] - centers[None, :, 0]
    dz = pts[:, 2:3] - centers[None, :, 2]
    y2 = np.square(pts[:, 1:2] * height)
    dist = np.sqrt(np.square(dx) + y2 + np.square(dz))
    near = np.clip(dist.min(axis=1) - status, 0.0, 100.0)
    cls = np.exp(-np.square(near) / (2.0 * cov)).astype(np.float32)
    nearest = dist.argmin(axis=1)
    fg = dist.min(axis=1) < 4.0
    reg[fg, 0] = centers[nearest[fg], 0] - pts[fg, 0]
    reg[fg, 2] = centers[nearest[fg], 2] - pts[fg, 2]
    return cls, reg


class RPNTrainLoader:
    """TRAIN batches of the first `weakly_num` scenes with weak labels;
    `tree` is the configuration file's tree."""

    def __init__(self, scenes, tree: dict, weakly_num: int, seed: int):
        self.scenes = scenes
        self.tree = tree
        self.npoints = int(tree["RPN"]["NUM_POINTS"])
        self.rng = np.random.RandomState(seed)
        ids = []
        for sid in scenes.sample_ids:
            if len(ids) >= weakly_num:
                break
            if len(scenes.get_scene(sid, with_noise=True).noise_labels):
                ids.append(sid)
        self.sample_ids = ids
        self.database = (gt_database(scenes, ids) if tree["GT_AUG_ENABLED"]
                         else None)

    def get_sample(self, index: int) -> Dict[str, np.ndarray]:
        t, rng = self.tree, self.rng
        rpn = t["RPN"]
        scene = self.scenes.get_scene(self.sample_ids[index],
                                      with_noise=True)
        lidar = scene.pts_lidar[np.argsort(-scene.pts_lidar[:, 2])]
        pts = scene.calib.lidar_to_rect(lidar[:, 0:3])
        inten = lidar[:, 3]
        weak = boxes_of(scene.noise_labels)
        extra = np.zeros((0, 7), np.float32)
        if self.database is not None and rng.rand() < t["GT_AUG_APPLY_PROB"]:
            pts, inten, extra = paste(pts, inten, weak, *self.database, rng)
        img, depth = scene.calib.rect_to_img(pts)
        ok = valid_point_mask(pts, img, depth, scene.image_shape,
                              t["PC_AREA_SCOPE"] if t["PC_REDUCE_BY_RANGE"]
                              else None)
        pts, inten, depth = pts[ok], inten[ok], depth[ok]
        choice = sample_npoints(len(pts), self.npoints, depth, rng)
        pts = pts[choice]
        inten = inten[choice] - 0.5
        pts_input = np.hstack([pts, inten[:, None]]).astype(np.float32)
        gt = np.concatenate([weak, extra]) if extra.shape[0] and \
            weak.shape[0] else (extra if extra.shape[0] else weak)
        if t["AUG_DATA"]:
            xyz, gt = global_aug(pts_input[:, :3], gt.reshape(-1, 7), rng,
                                 t["AUG_ROT_RANGE"], t["AUG_METHOD_PROB"])
            pts_input = pts_input.copy()
            pts_input[:, :3] = xyz
        if t["TPU"]["SORT_POINTS_Z"]:
            pts_input = pts_input[np.argsort(pts_input[:, 2], kind="stable")]
        n_gt = min(len(gt), MAX_GT)
        gt_pad = np.zeros((MAX_GT, 7), np.float32)
        gt_pad[:n_gt] = gt[:n_gt]
        cls, reg = gaussian_labels(
            pts_input[:, :3], gt[:, :3] if len(gt) else
            np.zeros((0, 3), np.float32), rpn["GAUSS_HEIGHT"],
            rpn["GAUSS_STATUS"], rpn["GAUSS_COV"])
        centers = np.zeros((MAX_GT, 3), np.float32)
        centers[:n_gt] = gt[:n_gt, :3]
        return {"pts_input": pts_input, "rpn_cls_label": cls,
                "rpn_reg_label": reg, "gt_centers": centers,
                "gt_boxes3d": gt_pad, "gt_count": np.int32(n_gt),
                "pasted": np.int32(extra.shape[0])}

    def batches(self, batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked batches of shuffled passes, forever."""
        while True:
            idxs = self.rng.permutation(len(self.sample_ids))
            for lo in range(0, len(idxs) - batch_size + 1, batch_size):
                chunk = [self.get_sample(int(i))
                         for i in idxs[lo:lo + batch_size]]
                yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}
