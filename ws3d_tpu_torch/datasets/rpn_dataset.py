"""EVAL-mode scene loader (NumPy copy of the EVAL path of
ws3d_tpu/datasets/rpn_dataset.py): image-FOV + range crop, the near/far
16,384-point sample drawn from a per-scene RNG, intensity shifted to
[-0.5, 0.5] and a stable sort ascending by rect z."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from ws3d_tpu_torch.datasets.kitti_io import objs_to_boxes3d

MAX_GT = 32


def valid_point_mask(pts_rect: np.ndarray, pts_img: np.ndarray,
                     pts_depth: np.ndarray, img_shape,
                     pc_area_scope) -> np.ndarray:
    """Image-FOV + area-scope crop."""
    ok = ((pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
          & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0])
          & (pts_depth >= 0))
    if pc_area_scope is not None:
        (x0, x1), (y0, y1), (z0, z1) = pc_area_scope
        ok &= ((pts_rect[:, 0] >= x0) & (pts_rect[:, 0] <= x1)
               & (pts_rect[:, 1] >= y0) & (pts_rect[:, 1] <= y1)
               & (pts_rect[:, 2] >= z0) & (pts_rect[:, 2] <= z1))
    return ok


def sample_npoints(n_have: int, npoints: int, depth: np.ndarray,
                   rng: np.random.RandomState) -> np.ndarray:
    """Near/far selection: all far (>= 40 m) points plus a random subset of
    the near ones; wraparound repetition when the scene is short."""
    if npoints < n_have:
        near = np.where(depth < 40.0)[0]
        far = np.where(depth >= 40.0)[0]
        take_near = npoints - len(far)
        if take_near > 0:
            near_choice = rng.choice(near, take_near, replace=False)
            choice = (np.concatenate([near_choice, far]) if len(far)
                      else near_choice)
        else:
            choice = rng.choice(np.arange(n_have), npoints, replace=False)
    else:
        choice = np.arange(n_have, dtype=np.int64)
        while npoints > len(choice):
            choice = np.concatenate([choice, np.arange(n_have, dtype=np.int64)])
        choice = rng.choice(choice, npoints, replace=False)
    rng.shuffle(choice)
    return choice


class RPNDataset:
    """Fixed-shape EVAL batches from a scene source (an object with
    .sample_ids and .get_scene(i, with_noise), e.g. SyntheticKitti)."""

    def __init__(self, source, cfg, mode: str = "EVAL",
                 npoints: Optional[int] = None, seed: int = 0):
        if mode != "EVAL":
            raise NotImplementedError("only the EVAL path is ported")
        self.source = source
        self.cfg = cfg
        self.mode = mode
        self.npoints = npoints or cfg.RPN.NUM_POINTS
        self.seed = seed
        self.sort_z = bool(cfg.TPU.get("SORT_POINTS_Z", True))
        self.sample_ids = list(source.sample_ids)

    def __len__(self):
        return len(self.sample_ids)

    def _eval_rng(self, index: int) -> np.random.RandomState:
        """The subsample is a pure function of (seed, sample_id)."""
        return np.random.RandomState(
            (self.seed * 100003 + 7919 * int(self.sample_ids[index]) + 1)
            % (2**31 - 1))

    def get_sample(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        scene = self.source.get_scene(self.sample_ids[index], with_noise=True)
        order = np.argsort(-scene.pts_lidar[:, 2])
        pts_lidar = scene.pts_lidar[order]
        pts_rect = scene.calib.lidar_to_rect(pts_lidar[:, 0:3])
        intensity = pts_lidar[:, 3]

        pts_img, depth = scene.calib.rect_to_img(pts_rect)
        ok = valid_point_mask(pts_rect, pts_img, depth, scene.image_shape,
                              cfg.PC_AREA_SCOPE if cfg.PC_REDUCE_BY_RANGE
                              else None)
        pts_rect, intensity, depth = pts_rect[ok], intensity[ok], depth[ok]
        choice = sample_npoints(len(pts_rect), self.npoints, depth,
                                self._eval_rng(index))
        pts_rect = pts_rect[choice]
        intensity = intensity[choice] - 0.5
        if cfg.RPN.USE_INTENSITY:
            pts_input = np.hstack([pts_rect,
                                   intensity[:, None]]).astype(np.float32)
        else:
            pts_input = pts_rect.astype(np.float32)
        if self.sort_z:
            pts_input = pts_input[np.argsort(pts_input[:, 2], kind="stable")]

        gt = objs_to_boxes3d([o for o in scene.labels
                              if o.cls_type in ("Car", "Van")])
        n_gt = min(len(gt), MAX_GT)
        gt_pad = np.zeros((MAX_GT, 7), np.float32)
        gt_pad[:n_gt] = gt[:n_gt]
        return {"sample_id": np.int32(scene.sample_id),
                "pts_input": pts_input, "gt_boxes3d": gt_pad,
                "gt_count": np.int32(n_gt)}

    def batches(self, batch_size: int,
                steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked batches in sample order (`steps` of them, or one pass)."""
        count = 0
        for lo in range(0, len(self) - batch_size + 1, batch_size):
            chunk = [self.get_sample(i) for i in range(lo, lo + batch_size)]
            yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}
            count += 1
            if steps is not None and count >= steps:
                return
