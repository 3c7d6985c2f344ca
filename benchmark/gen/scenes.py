"""Scene traffic for the inference cells: synthetic scenes sampled and
z-sorted as the port's EVAL loader samples them (a frozen copy of
datasets/rpn_dataset.py's EVAL path: the image-FOV and range crop, the
near/far 16,384-point sample from a per-scene RNG, intensity - 0.5, a
stable sort ascending by rect z). The program receives only the result,
(B, N, 4) float32 arrays."""
from __future__ import annotations

import hashlib

import numpy as np

from benchmark.gen.synthetic import SyntheticKitti

# SyntheticKitti seeds scene i with seed * 100003 + i, which must stay
# below 2**32: a run's seed is hashed into [0, SEED_SPAN)
SEED_SPAN = 42000


def sub_seed(seed: int, salt: str, span: int = SEED_SPAN) -> int:
    """A seed in [0, span) drawn from any whole number and a salt."""
    h = hashlib.sha256(f"{salt}:{int(seed)}".encode()).hexdigest()
    return int(h[:15], 16) % span


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



def eval_rng(seed: int, sample_id: int) -> np.random.RandomState:
    """The EVAL subsample's RNG, a pure function of (seed, sample_id)."""
    return np.random.RandomState((seed * 100003 + 7919 * int(sample_id) + 1)
                                 % (2**31 - 1))


def eval_scene(source: SyntheticKitti, sample_id: int, npoints: int,
               pc_area_scope, loader_seed: int = 0) -> np.ndarray:
    """One scene as the EVAL loader gives it: (npoints, 4) float32 sorted
    ascending by rect z."""
    scene = source.get_scene(sample_id, with_noise=True)
    order = np.argsort(-scene.pts_lidar[:, 2])
    pts_lidar = scene.pts_lidar[order]
    pts_rect = scene.calib.lidar_to_rect(pts_lidar[:, 0:3])
    intensity = pts_lidar[:, 3]
    pts_img, depth = scene.calib.rect_to_img(pts_rect)
    ok = valid_point_mask(pts_rect, pts_img, depth, scene.image_shape,
                          pc_area_scope)
    pts_rect, intensity, depth = pts_rect[ok], intensity[ok], depth[ok]
    choice = sample_npoints(len(pts_rect), npoints, depth,
                            eval_rng(loader_seed, sample_id))
    pts = np.hstack([pts_rect[choice], intensity[choice, None] - 0.5]
                    ).astype(np.float32)
    return pts[np.argsort(pts[:, 2], kind="stable")]


def scene_batches(seed: int, batch: int, n_batches: int, npoints: int,
                  points_per_scene: int, max_cars: int,
                  pc_area_scope) -> list:
    """`n_batches` distinct (batch, npoints, 4) float32 arrays of scenes
    drawn from `seed`."""
    src = SyntheticKitti(num_scenes=batch * n_batches, max_cars=max_cars,
                         points_per_scene=points_per_scene,
                         seed=sub_seed(seed, "scenes"))
    scenes = [eval_scene(src, i, npoints, pc_area_scope)
              for i in range(batch * n_batches)]
    return [np.stack(scenes[b * batch:(b + 1) * batch])
            for b in range(n_batches)]
