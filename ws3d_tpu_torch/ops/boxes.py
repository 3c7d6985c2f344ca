"""3D box geometry in KITTI rect-camera coordinates (port of
ws3d_tpu/ops/boxes.py). Boxes are (x, y, z, h, w, l, ry), y at the bottom
face centre, ry the heading around +y."""
from __future__ import annotations

import torch


def rotate_points_along_y(points: torch.Tensor,
                          angle: torch.Tensor) -> torch.Tensor:
    """points (..., N, 3+C) rotated by angle (...): x' = x cos - z sin,
    z' = x sin + z cos; extra channels pass through."""
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    x, z = points[..., 0], points[..., 2]
    xr = x * c - z * s
    zr = x * s + z * c
    return torch.cat([xr[..., None], points[..., 1:2], zr[..., None],
                      points[..., 3:]], dim=-1)


def boxes3d_to_bev(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 5) [x1, z1, x2, z2, ry]."""
    cu, cv = boxes3d[..., 0], boxes3d[..., 2]
    half_l, half_w = boxes3d[..., 5] / 2, boxes3d[..., 4] / 2
    return torch.stack([cu - half_l, cv - half_w, cu + half_l, cv + half_w,
                        boxes3d[..., 6]], dim=-1)
