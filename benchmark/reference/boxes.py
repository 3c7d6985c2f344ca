"""Frozen copy of the port's box geometry (ops/boxes.py): boxes are
(x, y, z, h, w, l, ry) in KITTI rect-camera coordinates, y at the bottom
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


_X_SIGNS = (0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5)
_Z_SIGNS = (0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5, 0.5)
_Y_SIGNS = (0.0, 0.0, 0.0, 0.0, -1.0, -1.0, -1.0, -1.0)


def boxes3d_to_corners3d(boxes3d: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 8, 3) corners: the bottom four (y = box y) first,
    then the top four (y - h); x' = c x + s z, z' = -s x + c z."""
    def signs(v):
        return torch.tensor(v, dtype=boxes3d.dtype, device=boxes3d.device)
    h, w, l = boxes3d[..., 3], boxes3d[..., 4], boxes3d[..., 5]
    ry = boxes3d[..., 6]
    x_c = l[..., None] * signs(_X_SIGNS)
    z_c = w[..., None] * signs(_Z_SIGNS)
    y_c = h[..., None] * signs(_Y_SIGNS)
    c, s = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    corners = torch.stack([c * x_c + s * z_c, y_c, -s * x_c + c * z_c],
                          dim=-1)
    return corners + boxes3d[..., None, 0:3]
