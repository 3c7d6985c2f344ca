"""Differentiable rotated 3D IoU / GIoU of aligned box pairs and their
losses (port of ws3d_tpu/ops/giou.py). Plain autograd through the
24-vertex overlap of ops.iou3d: no custom Function. The GIoU's enclosing
term is the convex hull of both boxes' BEV corners (an angle sort and the
shoelace over 8 vertices) times the enclosing height interval; gradients
flow through the gathers, not the sorts."""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops.boxes import boxes3d_to_bev
from ws3d_tpu_torch.ops.iou3d import _bev_corners, _overlap_pairs


def _hull_area_8(pts: torch.Tensor) -> torch.Tensor:
    """pts (..., 8, 2) -> (...) the shoelace area of the points in angular
    order about their centroid (the convex hull's area when all 8 are hull
    vertices)."""
    center = pts.mean(dim=-2, keepdim=True)
    ang = torch.atan2(pts[..., 1] - center[..., 1],
                      pts[..., 0] - center[..., 0])
    order = torch.argsort(ang, dim=-1, stable=True)
    sp = torch.gather(pts, -2, order[..., None].expand(pts.shape))
    nxt = torch.roll(sp, -1, dims=-2)
    return torch.abs(torch.sum(sp[..., 0] * nxt[..., 1]
                               - nxt[..., 0] * sp[..., 1], dim=-1)) / 2.0


def paired_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """Aligned (P, 7) bottom-y boxes -> (iou3d (P,), parts dict)."""
    bev_a = boxes3d_to_bev(boxes_a)
    bev_b = boxes3d_to_bev(boxes_b)
    inter_bev = _overlap_pairs(bev_a, bev_b)
    a_min, a_max = boxes_a[:, 1] - boxes_a[:, 3], boxes_a[:, 1]
    b_min, b_max = boxes_b[:, 1] - boxes_b[:, 3], boxes_b[:, 1]
    ih = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min),
                     min=0.0)
    inter = inter_bev * ih
    vol_a = boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5]
    vol_b = boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5]
    union = torch.clamp(vol_a + vol_b - inter, min=1e-7)
    return inter / union, {"inter": inter, "union": union,
                           "bev_a": bev_a, "bev_b": bev_b,
                           "h_lo": torch.minimum(a_min, b_min),
                           "h_hi": torch.maximum(a_max, b_max)}


def paired_giou3d(boxes_a: torch.Tensor,
                  boxes_b: torch.Tensor) -> torch.Tensor:
    """Aligned (P, 7) -> (P,) 3D GIoU: iou - (enclosure - union) /
    enclosure."""
    iou, parts = paired_iou3d(boxes_a, boxes_b)
    hull = _hull_area_8(torch.cat([_bev_corners(parts["bev_a"]),
                                   _bev_corners(parts["bev_b"])], dim=-2))
    enc = hull * torch.clamp(parts["h_hi"] - parts["h_lo"], min=0.0)
    enc = torch.clamp(enc, min=1e-7)
    return iou - (enc - parts["union"]) / enc


def ious_3d_loss(gt_boxes: torch.Tensor,
                 pred_boxes: torch.Tensor) -> torch.Tensor:
    """mean(1 - iou3d) over aligned rows."""
    iou, _ = paired_iou3d(pred_boxes, gt_boxes)
    return torch.mean(1.0 - iou)


def gious_3d_loss(gt_boxes: torch.Tensor,
                  pred_boxes: torch.Tensor) -> torch.Tensor:
    """mean(1 - giou3d) over aligned rows."""
    return torch.mean(1.0 - paired_giou3d(pred_boxes, gt_boxes))
