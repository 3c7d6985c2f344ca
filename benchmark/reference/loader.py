"""Frozen copy of the stage-2 proposal-crop loader's TRAIN batches
(the port's datasets/boxplace_dataset.py): the same database, mode and
seed give the same batches. Every draw comes from one RandomState in a
fixed order: mask sign-flip noise, a shuffle, quadrant dropout, the
truncation trick, a wraparound pad to 512, the noise pack (x-flip, heading,
Gaussian translation, global scale and per-axis size noise, copies 1..
recentred on the gt box), a stable z sort, then the batch's mask choice."""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional

import numpy as np

NPOINTS = 512


def _rot_y(points: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    out = points.copy()
    out[:, 0] = points[:, 0] * c - points[:, 2] * s
    out[:, 2] = points[:, 0] * s + points[:, 2] * c
    return out


class BoxPlaceDataset:
    """Fixed-shape stage-2 crop batches from a proposal database.

    database: list of dicts with keys sample_id, box_id, center (3,),
    foreground_flag (bool), gt_boxes (7,) crop-frame bottom-y gt box (zeros
    for background), cur_box_point (N, 3) with N free, cur_box_reflect (N,),
    cur_prob_mask (N,) raw sigmoid RPN scores, gt_mask (N,) 0/1 (the records
    of tools/generate_box_dataset.py; the JAX package's pickle is plain
    NumPy and loads here). mask_format "raw" converts the masks at load time:
    prob -> (raw > 0.5) - 0.5, gt -> raw - 0.5.
    """

    def __init__(self, database: List[Dict], cfg, mode: str = "TRAIN",
                 npoints: int = NPOINTS, seed: int = 666,
                 aug_copies: int = 4, weakly_ratio: Optional[float] = None,
                 mask_format: str = "raw"):
        assert mask_format in ("raw", "pm"), mask_format
        self.mask_format = mask_format
        self.cfg = cfg
        self.mode = mode
        self.npoints = npoints
        self.sort_z = bool(cfg.TPU.get("SORT_POINTS_Z", True))
        self.rng = np.random.RandomState(seed)
        entries = list(range(len(database)))
        if weakly_ratio is not None and mode == "TRAIN":
            # the weakly-labelled instance budget, shuffled with a fixed seed
            r = np.random.RandomState(666)
            r.shuffle(entries)
            entries = entries[: int(len(entries) * weakly_ratio)]
        self.database = database
        # TRAIN: aug_copies copies per instance, the copy index as aug flag
        self.index = []
        copies = aug_copies if mode == "TRAIN" else 1
        for c in range(copies):
            self.index += [(i, c) for i in entries]

    def __len__(self):
        return len(self.index)

    def get_sample(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        db_i, aug_flag = self.index[idx]
        data = self.database[db_i]
        rng = self.rng

        pts = np.array(data["cur_box_point"], np.float32).reshape(-1, 3).copy()
        reflect = np.array(data["cur_box_reflect"],
                           np.float32).reshape(-1).copy()
        prob_mask = np.array(data["cur_prob_mask"],
                             np.float32).reshape(-1).copy()
        gt_mask = np.array(data["gt_mask"], np.float32).reshape(-1).copy()
        if self.mask_format == "raw":
            prob_mask = (prob_mask > 0.5).astype(np.float32) - 0.5
            gt_mask = gt_mask - 0.5
        gt_box = np.array(data["gt_boxes"], np.float32).reshape(-1)[:7].copy()
        fg = bool(data["foreground_flag"])
        cls = np.float32(1.0 if fg else 0.0)

        # ground shift
        pts[:, 1] -= 1.65
        gt_box[1] -= 1.65
        if self.mode != "TRAIN":
            gt_mask = prob_mask.copy()

        if self.mode == "TRAIN":
            flip_noise = rng.uniform(0, 1, prob_mask.shape[0]) > 0.95
            prob_mask[flip_noise] = -prob_mask[flip_noise]
            gt_mask[flip_noise] = -gt_mask[flip_noise]

            perm = rng.permutation(pts.shape[0])
            pts, reflect = pts[perm], reflect[perm]
            prob_mask, gt_mask = prob_mask[perm], gt_mask[perm]

            # region dropout: quadrants around the gt centre
            r6 = rng.uniform(-1, 1, 6)
            if r6[0] > 0.5:
                ix = (prob_mask > 0) & ((pts[:, 0] > gt_box[0]) if r6[1] > 0
                                        else (pts[:, 0] < gt_box[0]))
                iz = (prob_mask > 0) & ((pts[:, 2] > gt_box[2]) if r6[2] > 0.5
                                        else (pts[:, 2] < gt_box[2]))
                drop = (ix | iz) if r6[5] > 0 else (ix & iz)
                if r6[4] > 0.5:
                    drop = drop | (prob_mask < 0)
            else:
                drop = np.ones(pts.shape[0], bool)
            if not np.any(drop & (gt_mask > 0)):
                drop = np.ones(pts.shape[0], bool)
            pts, reflect = pts[drop], reflect[drop]
            prob_mask, gt_mask = prob_mask[drop], gt_mask[drop]

            # truncation trick: sometimes keep only the first 128 / 32 points
            pts = pts[:self.npoints]
            reflect, prob_mask, gt_mask = (reflect[:self.npoints],
                                           prob_mask[:self.npoints],
                                           gt_mask[:self.npoints])
            if pts.shape[0] == self.npoints and r6[3] > 0.5:
                keep = 32 if r6[3] > 0.7 else 128
                pts, reflect = pts[:keep], reflect[:keep]
                prob_mask, gt_mask = prob_mask[:keep], gt_mask[:keep]

        if self.mode != "TRAIN" and pts.shape[0] > self.npoints:
            # EVAL: the first npoints in record order
            pts, reflect = pts[:self.npoints], reflect[:self.npoints]
            prob_mask = prob_mask[:self.npoints]
            gt_mask = gt_mask[:self.npoints]

        # wraparound pad to npoints
        n = pts.shape[0]
        if n == 0:
            pts = np.zeros((1, 3), np.float32)
            reflect = np.zeros((1,), np.float32)
            prob_mask = np.zeros((1,), np.float32)
            gt_mask = np.zeros((1,), np.float32)
            n = 1
        sel = np.arange(n)
        while sel.shape[0] < self.npoints:
            sel = np.concatenate([sel, sel[: self.npoints - sel.shape[0]]])
        pts, reflect = pts[sel], reflect[sel]
        prob_mask, gt_mask = prob_mask[sel], gt_mask[sel]

        if self.mode == "TRAIN":
            noise = rng.uniform(-1, 1, 6)
            if aug_flag == 0:
                noise = np.zeros(6)
            g = rng.normal(0, 0.1, 3)
            ext = 1.0 + rng.normal(0, 0.1, 3) * 0.20          # scales (h, w, l)
            scale = 1.0 + rng.normal(0, 0.1) / 2 * 0.20

            # rotation by noise_ry ~ U(-pi/2, pi/2): with x' = x cos - z sin
            # a rotation by +theta maps the heading a -> a - theta
            noise_ry = noise[3] * math.pi / 2

            # x-flip
            if noise[5] > 0:
                pts[:, 0] = -pts[:, 0]
                gt_box[0] = -gt_box[0]
                gt_box[6] = (math.pi - gt_box[6]) % (2 * math.pi)
                if gt_box[6] >= math.pi:
                    gt_box[6] -= 2 * math.pi
                noise_ry = -noise_ry

            # recentre on the gt box, augmented copies only
            if aug_flag != 0 and fg and np.any(gt_box):
                pts[:, 0] -= gt_box[0]
                pts[:, 2] -= gt_box[2]
                gt_box[0] = 0.0
                gt_box[2] = 0.0

            # per-axis size noise in the gt-heading frame about the origin
            local = _rot_y(pts, gt_box[6])
            local[:, 0] *= ext[2]      # x along length
            local[:, 1] *= ext[0]      # y along height
            local[:, 2] *= ext[1]      # z along width
            pts = _rot_y(local, -gt_box[6])
            if fg and np.any(gt_box):
                gt_box[3:6] *= ext

            # global scale
            pts *= scale
            gt_box[0:6] *= scale

            # rotate the crop by noise_ry, then the Gaussian translation
            pts = _rot_y(pts, noise_ry)
            pts += np.array([g[0], noise[2], g[1]], np.float32)
            c, s = np.cos(noise_ry), np.sin(noise_ry)
            gx = gt_box[0] * c - gt_box[2] * s + g[0]
            gz = gt_box[0] * s + gt_box[2] * c + g[1]
            gt_box[0], gt_box[2] = gx, gz
            gt_box[1] += noise[2]
            gt_box[6] = (gt_box[6] - noise_ry) % (2 * math.pi)
            if gt_box[6] > math.pi:
                gt_box[6] -= 2 * math.pi

        if self.sort_z:
            order = np.argsort(pts[:, 2], kind="stable")
            pts, reflect = pts[order], reflect[order]
            prob_mask, gt_mask = prob_mask[order], gt_mask[order]

        sample = {
            "sample_id": np.int32(data.get("sample_id", 0)),
            "box_id": np.int32(data.get("box_id", 0)),
            "cls": cls,
            "gt_boxes": (gt_box * cls).astype(np.float32),
            "cur_box_point": pts.astype(np.float32),
            "cur_box_reflect": reflect.reshape(-1, 1).astype(np.float32),
            "cur_prob_mask": prob_mask.reshape(-1, 1).astype(np.float32),
            "gt_mask": gt_mask.reshape(-1, 1).astype(np.float32),
        }

        if cfg.IOUN.ENABLED:
            casc = cfg.CASCADE
            damp = 0.5 ** (casc - 1)
            trans, scl, ry = [], [], []
            for _ in range(casc):
                if self.mode == "TRAIN":
                    n6 = rng.normal(0, 0.1, 6) * damp
                    trans.append(n6[0:3])
                    scl.append(np.full(3, 1.0 + n6[3] * 0.2))
                    ry.append([n6[4] * math.pi / 10])
                else:
                    trans.append(np.zeros(3))
                    scl.append(np.ones(3))
                    ry.append([0.0])
            sample["iou_trans"] = np.stack(trans, axis=-1).astype(np.float32)
            sample["iou_scale"] = np.stack(scl, axis=-1).astype(np.float32)
            sample["iou_ry"] = np.stack(ry, axis=-1).astype(np.float32)
        return sample

    def batches(self, batch_size: int, steps: Optional[int] = None,
                shuffle: bool = True,
                prob_mask_ratio: float = 1.0
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked batches; train_mask is the predicted mask with
        probability prob_mask_ratio, else the gt mask (Trainer's
        prob_mask_ratio schedule)."""
        count = 0
        while steps is None or count < steps:
            idxs = (self.rng.permutation(len(self)) if shuffle
                    else np.arange(len(self)))
            for lo in range(0, len(idxs) - batch_size + 1, batch_size):
                chunk = [self.get_sample(int(i))
                         for i in idxs[lo:lo + batch_size]]
                batch = {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}
                use_prob = self.rng.random_sample() <= prob_mask_ratio
                batch["train_mask"] = (batch["cur_prob_mask"] if use_prob
                                       else batch["gt_mask"])
                yield batch
                count += 1
                if steps is not None and count >= steps:
                    return

