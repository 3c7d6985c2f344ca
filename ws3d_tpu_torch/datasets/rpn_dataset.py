"""Stage-1 scene loader (NumPy copy of ws3d_tpu/datasets/rpn_dataset.py):
image-FOV + range crop, the near/far 16,384-point sample, intensity shifted
to [-0.5, 0.5] and a stable sort ascending by rect z.

EVAL draws each scene's sample from an RNG of its own. TRAIN draws the
sample, the global augmentation (rotation, scaling, x-flip) and the
shuffle from one stream, `self.rng`, in the JAX package's order, so both
packages give the same batches for the same seed; its labels are Gaussian
soft labels around the noisy weak-label centres. With a GT database (the
(easy, hard) pair of datasets.gt_database.build_gt_database) and
cfg.GT_AUG_ENABLED, a TRAIN scene first draws GT_AUG_APPLY_PROB from the
stream and, if taken, gets the copy-paste augmentation before the crop;
the pasted boxes join its labels. A scene with more than MAX_GT boxes keeps
every box for its labels and the first MAX_GT in gt_boxes3d / gt_centers.

Spans (utils.profiling, recorded only while a profiler records):
`loader.sample` a sample, `loader.batch` a stacked batch, `loader.gt_aug`
the copy-paste augmentation, `loader.labels` the Gaussian labels; the
counter `loader.gt_pasted` adds the boxes pasted into each sample."""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np

from ws3d_tpu_torch.datasets.gt_database import apply_gt_aug
from ws3d_tpu_torch.datasets.kitti_io import objs_to_boxes3d
from ws3d_tpu_torch.utils.profiling import count, span

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


def rotate_pc_along_y_np(pc: np.ndarray, angle: float) -> np.ndarray:
    """In-place x/z rotation."""
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]], dtype=pc.dtype)
    pc[:, [0, 2]] = pc[:, [0, 2]] @ R
    return pc


def augment_scene(pts_rect: np.ndarray, gt_boxes3d: np.ndarray,
                  rng: np.random.RandomState,
                  rot_range: float = 18.0,
                  method_prob: Sequence[float] = (1.0, 1.0, 0.5)):
    """Global rotation / scaling / x-flip, each taken with its probability;
    -> (pts_rect, gt_boxes3d, methods)."""
    enable = 1.0 - rng.rand(3)
    methods = []
    if enable[0] < method_prob[0]:
        angle = rng.uniform(-np.pi / rot_range, np.pi / rot_range)
        pts_rect = rotate_pc_along_y_np(pts_rect.copy(), angle)
        gt_boxes3d = rotate_pc_along_y_np(gt_boxes3d.copy(), angle)
        methods.append(("rotation", angle))
    if enable[1] < method_prob[1]:
        scale = rng.uniform(0.95, 1.05)
        pts_rect = pts_rect * scale
        gt_boxes3d = gt_boxes3d.copy()
        gt_boxes3d[:, 0:6] *= scale
        methods.append(("scaling", scale))
    if enable[2] < method_prob[2]:
        pts_rect = pts_rect.copy()
        gt_boxes3d = gt_boxes3d.copy()
        pts_rect[:, 0] = -pts_rect[:, 0]
        gt_boxes3d[:, 0] = -gt_boxes3d[:, 0]
        methods.append(("flip",))
    return pts_rect, gt_boxes3d, methods


def gaussian_weak_labels(pts_rect: np.ndarray, gt_centers: np.ndarray,
                         gauss_height: float = 0.707,
                         gauss_status: float = 0.7,
                         gauss_cov: float = 1.5):
    """Gaussian soft cls labels + nearest-centre reg targets.

    cls = exp(-clip(d - status, 0)^2 / (2 cov)) with
    d = sqrt((x-cx)^2 + (y*gauss_height)^2 + (z-cz)^2) to the nearest
    centre; reg = (dx, 0, dz) to it for points with d < 4 m."""
    n = pts_rect.shape[0]
    cls_label = np.zeros((n,), np.float32)
    reg_label = np.zeros((n, 3), np.float32)
    if gt_centers.shape[0] == 0:
        return cls_label, reg_label
    dx = pts_rect[:, 0:1] - gt_centers[None, :, 0]
    dz = pts_rect[:, 2:3] - gt_centers[None, :, 2]
    y2 = np.square(pts_rect[:, 1:2] * gauss_height)
    dist = np.sqrt(np.square(dx) + y2 + np.square(dz))     # (N, K)
    min_dist = np.clip(dist.min(axis=1) - gauss_status, 0.0, 100.0)
    cls_label = np.exp(-np.square(min_dist)
                       / (2.0 * gauss_cov)).astype(np.float32)
    nearest = dist.argmin(axis=1)
    fg = dist.min(axis=1) < 4.0
    reg_label[fg, 0] = gt_centers[nearest[fg], 0] - pts_rect[fg, 0]
    reg_label[fg, 2] = gt_centers[nearest[fg], 2] - pts_rect[fg, 2]
    return cls_label, reg_label


def points_in_rotated_boxes_np(pts: np.ndarray,
                               boxes: np.ndarray) -> np.ndarray:
    """pts (N, 3), boxes (G, 7) bottom-centre (x, y, z, h, w, l, ry) ->
    (N, G) bool: inside each box, faces included."""
    shift = pts[:, None, :] - boxes[None, :, 0:3]
    h, w, l, ry = boxes[:, 3], boxes[:, 4], boxes[:, 5], boxes[:, 6]
    cy = -h / 2.0
    c, s = np.cos(ry), np.sin(ry)
    x_loc = shift[..., 0] * c - shift[..., 2] * s
    z_loc = shift[..., 0] * s + shift[..., 2] * c
    return ((np.abs(x_loc) <= l / 2.0) & (np.abs(z_loc) <= w / 2.0)
            & (np.abs(shift[..., 1] - cy) <= h / 2.0))


def box_rpn_labels(pts_rect: np.ndarray, gt_boxes3d: np.ndarray,
                   ignore_width: float = 0.2):
    """Box labels (the JAX loader's EVAL labels): cls +1 inside a box, -1
    in the ring of the box enlarged by `ignore_width`, else 0 (int32); reg
    the (dx, 0, dz) to the centre of the box a point is in."""
    n = pts_rect.shape[0]
    cls_label = np.zeros((n,), np.int32)
    reg_label = np.zeros((n, 3), np.float32)
    if gt_boxes3d.shape[0] == 0:
        return cls_label, reg_label
    big_boxes = gt_boxes3d.copy()
    big_boxes[:, 1] += ignore_width
    big_boxes[:, 3:6] += ignore_width * 2
    in_box = points_in_rotated_boxes_np(pts_rect, gt_boxes3d)
    big = points_in_rotated_boxes_np(pts_rect, big_boxes)
    fg = in_box.any(axis=1)
    cls_label[fg] = 1
    cls_label[big.any(axis=1) & ~fg] = -1
    for k in range(gt_boxes3d.shape[0]):
        m = in_box[:, k]
        center = gt_boxes3d[k, 0:3].copy()
        center[1] = 0.0
        reg_label[m] = center - pts_rect[m]
        reg_label[m, 1] = 0.0
    return cls_label, reg_label


class RPNDataset:
    """Fixed-shape batches from a scene source (an object with .sample_ids
    and .get_scene(i, with_noise), e.g. SyntheticKitti).

    TRAIN with `weakly_num` keeps the first weakly_num scenes that have
    weak labels; `gt_database` (easy_db, hard_db) turns on the copy-paste
    augmentation of TRAIN scenes."""

    def __init__(self, source, cfg, mode: str = "EVAL",
                 npoints: Optional[int] = None,
                 weakly_num: Optional[int] = None, seed: int = 0,
                 gt_database=None):
        if mode not in ("TRAIN", "EVAL"):
            raise ValueError(f"mode {mode!r}: TRAIN or EVAL")
        self.source = source
        self.cfg = cfg
        self.mode = mode
        self.npoints = npoints or cfg.RPN.NUM_POINTS
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.sort_z = bool(cfg.TPU.get("SORT_POINTS_Z", True))
        self.gt_database = gt_database
        ids = list(source.sample_ids)
        if weakly_num is not None and mode == "TRAIN":
            kept = []
            for sid in ids:
                if len(source.get_scene(sid, with_noise=True).noise_labels):
                    kept.append(sid)
                if len(kept) >= weakly_num:
                    break
            ids = kept
        self.sample_ids = ids

    def __len__(self):
        return len(self.sample_ids)

    def _eval_rng(self, index: int) -> np.random.RandomState:
        """The subsample is a pure function of (seed, sample_id)."""
        return np.random.RandomState(
            (self.seed * 100003 + 7919 * int(self.sample_ids[index]) + 1)
            % (2**31 - 1))

    def get_whole_scene(self, index: int, max_points: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
        """Every valid point of a scene (the proposal database's input):
        the image-FOV and range crop, intensity - 0.5, sorted by rect z,
        with no 16,384-point sample. With `max_points` the cloud has that
        fixed size: a larger scene is subsampled (sorted indices drawn from
        the scene's own RNG), a smaller one padded by repeating its last
        point under SORT_POINTS_Z (which keeps it sorted) or cyclically
        otherwise, the padding marked invalid.

        Returns dict(pts_input (P, 3+C), valid (P,) bool, n_valid int32,
        gt_boxes (G, 7) real Car/Van labels, noise_boxes (Gn, 7) weak
        labels, sample_id)."""
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
        pts_rect, intensity = pts_rect[ok], intensity[ok] - 0.5
        if cfg.RPN.USE_INTENSITY:
            pts_input = np.hstack([pts_rect,
                                   intensity[:, None]]).astype(np.float32)
        else:
            pts_input = pts_rect.astype(np.float32)
        if self.sort_z:
            pts_input = pts_input[np.argsort(pts_input[:, 2], kind="stable")]

        n = pts_input.shape[0]
        if max_points is None:
            valid = np.ones(n, bool)
        elif n > max_points:
            choice = np.sort(self._eval_rng(index).choice(
                n, max_points, replace=False))
            pts_input = pts_input[choice]
            n = max_points
            valid = np.ones(max_points, bool)
        else:
            if self.sort_z and n > 0:
                pad_idx = np.minimum(np.arange(max_points), n - 1)
            else:
                pad_idx = np.arange(max_points) % max(n, 1)
            pts_input = pts_input[pad_idx]
            valid = np.zeros(max_points, bool)
            valid[:n] = True

        def boxes(objs):
            return objs_to_boxes3d([o for o in objs if o.cls_type in
                                    ("Car", "Van")]).reshape(-1, 7)
        return {"pts_input": pts_input, "valid": valid,
                "n_valid": np.int32(n), "gt_boxes": boxes(scene.labels),
                "noise_boxes": boxes(scene.noise_labels),
                "sample_id": np.int32(scene.sample_id)}

    @span("loader.sample")
    def get_sample(self, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        scene = self.source.get_scene(self.sample_ids[index], with_noise=True)
        order = np.argsort(-scene.pts_lidar[:, 2])
        pts_lidar = scene.pts_lidar[order]
        pts_rect = scene.calib.lidar_to_rect(pts_lidar[:, 0:3])
        intensity = pts_lidar[:, 3]
        train = self.mode == "TRAIN"

        extra_boxes = np.zeros((0, 7), np.float32)
        if (train and cfg.GT_AUG_ENABLED and self.gt_database is not None
                and self.rng.rand() < cfg.GT_AUG_APPLY_PROB):
            noise_boxes = objs_to_boxes3d([o for o in scene.noise_labels
                                           if o.cls_type in ("Car", "Van")])
            with span("loader.gt_aug"):
                pts_rect, intensity, extra_boxes = apply_gt_aug(
                    pts_rect, intensity, noise_boxes, self.gt_database[0],
                    self.gt_database[1], self.rng)
            count("loader.gt_pasted", extra_boxes.shape[0])

        pts_img, depth = scene.calib.rect_to_img(pts_rect)
        ok = valid_point_mask(pts_rect, pts_img, depth, scene.image_shape,
                              cfg.PC_AREA_SCOPE if cfg.PC_REDUCE_BY_RANGE
                              else None)
        pts_rect, intensity, depth = pts_rect[ok], intensity[ok], depth[ok]
        rng = self.rng if train else self._eval_rng(index)
        choice = sample_npoints(len(pts_rect), self.npoints, depth, rng)
        pts_rect = pts_rect[choice]
        intensity = intensity[choice] - 0.5
        if cfg.RPN.USE_INTENSITY:
            pts_input = np.hstack([pts_rect,
                                   intensity[:, None]]).astype(np.float32)
        else:
            pts_input = pts_rect.astype(np.float32)

        gt_objs = scene.noise_labels if train else scene.labels
        gt = objs_to_boxes3d([o for o in gt_objs
                              if o.cls_type in ("Car", "Van")])
        if extra_boxes.shape[0]:
            gt = np.concatenate([gt, extra_boxes]) if gt.shape[0] \
                else extra_boxes
        if train and cfg.AUG_DATA:
            aug_pts, gt, _ = augment_scene(
                pts_input[:, :3], gt.reshape(-1, 7), self.rng,
                rot_range=cfg.AUG_ROT_RANGE, method_prob=cfg.AUG_METHOD_PROB)
            pts_input = pts_input.copy()
            pts_input[:, :3] = aug_pts
        if self.sort_z:
            # after the augmentation (rotation changes z); labels follow
            pts_input = pts_input[np.argsort(pts_input[:, 2], kind="stable")]

        n_gt = min(len(gt), MAX_GT)
        gt_pad = np.zeros((MAX_GT, 7), np.float32)
        gt_pad[:n_gt] = gt[:n_gt]
        sample = {"sample_id": np.int32(scene.sample_id),
                  "pts_input": pts_input}
        if train:
            with span("loader.labels"):
                cls_label, reg_label = gaussian_weak_labels(
                    pts_input[:, :3], gt[:, :3] if len(gt) else
                    np.zeros((0, 3), np.float32),
                    gauss_height=cfg.RPN.GAUSS_HEIGHT,
                    gauss_status=cfg.RPN.GAUSS_STATUS,
                    gauss_cov=cfg.RPN.GAUSS_COV)
            gt_centers = np.zeros((MAX_GT, 3), np.float32)
            gt_centers[:n_gt] = gt[:n_gt, :3]
            sample.update(rpn_cls_label=cls_label, rpn_reg_label=reg_label,
                          gt_centers=gt_centers)
        sample.update(gt_boxes3d=gt_pad, gt_count=np.int32(n_gt))
        return sample

    def batches(self, batch_size: int, steps: Optional[int] = None,
                shuffle: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked batches, `steps` of them. With shuffle, each pass takes
        a fresh permutation from self.rng and passes repeat (forever when
        steps is None); without, samples go in order and steps=None means
        one pass. A pass yields len // batch_size batches."""
        if batch_size > len(self):
            raise ValueError(f"batch {batch_size} > {len(self)} scenes")
        count = 0
        while True:
            idxs = (self.rng.permutation(len(self)) if shuffle
                    else np.arange(len(self)))
            for lo in range(0, len(idxs) - batch_size + 1, batch_size):
                with span("loader.batch"):
                    chunk = [self.get_sample(int(i))
                             for i in idxs[lo:lo + batch_size]]
                    batch = {k: np.stack([c[k] for c in chunk])
                             for k in chunk[0]}
                yield batch
                count += 1
                if steps is not None and count >= steps:
                    return
            if steps is None and not shuffle:
                return
