"""RoI point pooling: first-k in-box / in-cylinder selection with `s % cnt`
wraparound (port of ws3d_tpu/ops/roipool.py). An empty box raises its
empty flag and pools zeros."""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops.boxes import enlarge_box3d, points_in_rotated_boxes
from ws3d_tpu_torch.ops.grouping import first_k_true_indices


def first_k_wraparound(mask: torch.Tensor, k: int):
    """mask (..., N) bool -> (idx (..., k) int64, empty (...,) bool): first-k
    true positions in ascending order, repeated cyclically when fewer."""
    N = mask.shape[-1]
    kk = min(k, N)
    sel = first_k_true_indices(mask, kk)
    cnt = mask.sum(-1)
    empty = cnt == 0
    slots = torch.arange(k, device=mask.device)
    wrap = torch.clamp(slots % torch.clamp(cnt, min=1)[..., None], max=kk - 1)
    idx = torch.gather(sel, -1, wrap)
    return torch.where(empty[..., None], 0, idx), empty


def roipool3d(pts: torch.Tensor, features: torch.Tensor,
              boxes3d: torch.Tensor, extra_width: float = 1.0,
              num_sampled: int = 512):
    """pts (N, 3), features (N, C), boxes3d (M, 7) bottom-y -> (pooled
    (M, num_sampled, 3 + C), empty (M,) bool): the first points inside each
    box enlarged by `extra_width`."""
    mask = points_in_rotated_boxes(pts, enlarge_box3d(boxes3d,
                                                      extra_width)).T
    idx, empty = first_k_wraparound(mask, num_sampled)
    pooled = torch.cat([pts, features], dim=-1)[idx]
    return torch.where(empty[:, None, None], 0.0, pooled), empty


def cylinder_crop(pts: torch.Tensor, features: torch.Tensor,
                  centers_xz: torch.Tensor, radius: float = 4.0,
                  num_sampled: int = 512):
    """The points within a BEV `radius` of each centre, recentred in x/z.
    pts (N, 3), features (N, C), centers_xz (M, 2) -> (xyz (M, k, 3),
    feats (M, k, C), empty (M,) bool)."""
    dx = pts[None, :, 0] - centers_xz[:, None, 0]
    dz = pts[None, :, 2] - centers_xz[:, None, 1]
    idx, empty = first_k_wraparound(dx * dx + dz * dz < radius * radius,
                                    num_sampled)
    offs = torch.stack([centers_xz[:, 0], torch.zeros_like(centers_xz[:, 0]),
                        centers_xz[:, 1]], dim=-1)
    xyz = pts[idx] - offs[:, None, :]
    zero = empty[:, None, None]
    return (torch.where(zero, 0.0, xyz), torch.where(zero, 0.0, features[idx]),
            empty)
