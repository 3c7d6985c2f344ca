"""KITTI records for the host data path (NumPy copies of the parts of
ws3d_tpu/datasets/kitti_io.py that the synthetic scenes and the EVAL loader
need): Calibration, Object3d, KittiScene, objs_to_boxes3d."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


class Calibration:
    """KITTI calibration: lidar -> rect and rect -> image projections."""

    def __init__(self, P2: np.ndarray, R0: np.ndarray, V2C: np.ndarray):
        self.P2 = P2.astype(np.float32)          # (3, 4)
        self.R0 = R0.astype(np.float32)          # (3, 3)
        self.V2C = V2C.astype(np.float32)        # (3, 4)
        self.cu, self.cv = self.P2[0, 2], self.P2[1, 2]
        self.fu, self.fv = self.P2[0, 0], self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @classmethod
    def identity(cls, fu: float = 700.0, cu: float = 600.0,
                 cv: float = 180.0) -> "Calibration":
        """A synthetic camera: rect == lidar frame."""
        P2 = np.array([[fu, 0, cu, 0], [0, fu, cv, 0], [0, 0, 1, 0]],
                      np.float32)
        return cls(P2, np.eye(3, dtype=np.float32),
                   np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32))

    @classmethod
    def realistic(cls) -> "Calibration":
        """Real-KITTI-style calibration (the public devkit example values)."""
        P2 = np.array([[721.5377, 0.0, 609.5593, 44.85728],
                       [0.0, 721.5377, 172.854, 0.2163791],
                       [0.0, 0.0, 1.0, 0.002745884]], np.float32)
        R0 = np.array([[0.9999239, 0.00983776, -0.007445048],
                       [-0.009869795, 0.9999421, -0.004278459],
                       [0.007402527, 0.004351614, 0.9999631]], np.float32)
        V2C = np.array([[0.007533745, -0.9999714, -0.000616602, -0.004069766],
                        [0.01480249, 0.000728073, -0.9998902, -0.07631618],
                        [0.9998621, 0.00752379, 0.01480755, -0.2717806]],
                       np.float32)
        return cls(P2, R0, V2C)

    def rect_to_lidar(self, pts_rect: np.ndarray) -> np.ndarray:
        cam = pts_rect @ np.linalg.inv(self.R0).T
        R, t = self.V2C[:, :3], self.V2C[:, 3]
        return (cam - t) @ np.linalg.inv(R).T

    @staticmethod
    def _hom(pts: np.ndarray) -> np.ndarray:
        return np.hstack((pts, np.ones((pts.shape[0], 1), dtype=np.float32)))

    def lidar_to_rect(self, pts_lidar: np.ndarray) -> np.ndarray:
        return self._hom(pts_lidar) @ (self.V2C.T @ self.R0.T)

    def rect_to_img(self, pts_rect: np.ndarray):
        hom = self._hom(pts_rect) @ self.P2.T
        img = hom[:, 0:2] / hom[:, 2:3]
        depth = hom[:, 2] - self.P2.T[3, 2]
        return img, depth

    def corners3d_to_img_boxes(self, corners3d: np.ndarray):
        """(N, 8, 3) rect corners -> ((N, 4) [x1 y1 x2 y2], (N, 8, 2))."""
        n = corners3d.shape[0]
        hom = np.concatenate([corners3d, np.ones((n, 8, 1))], axis=2)
        pts = hom @ self.P2.T
        x = pts[:, :, 0] / pts[:, :, 2]
        y = pts[:, :, 1] / pts[:, :, 2]
        boxes = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
        return boxes, np.stack([x, y], axis=2)


@dataclass
class Object3d:
    """One KITTI label line."""
    cls_type: str
    trucation: float
    occlusion: float
    alpha: float
    box2d: np.ndarray            # (4,) x1 y1 x2 y2
    h: float
    w: float
    l: float
    pos: np.ndarray              # (3,) rect coords, bottom-center
    ry: float
    score: float = -1.0

    def to_box3d(self) -> np.ndarray:
        """-> (7,) [x, y, z, h, w, l, ry] bottom-y."""
        return np.array([*self.pos, self.h, self.w, self.l, self.ry],
                        dtype=np.float32)


def objs_to_boxes3d(objs: List[Object3d]) -> np.ndarray:
    if not objs:
        return np.zeros((0, 7), dtype=np.float32)
    return np.stack([o.to_box3d() for o in objs])


@dataclass
class KittiScene:
    """Everything loaded for one frame."""
    sample_id: int
    pts_lidar: np.ndarray                      # (N, 4) x y z intensity
    calib: Calibration
    image_shape: tuple                         # (H, W)
    labels: List[Object3d] = field(default_factory=list)
    noise_labels: List[Object3d] = field(default_factory=list)  # weak clicks
