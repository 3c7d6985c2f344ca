"""Frozen copy of the stage-2 RCNN loss (the port's losses.py): BCE
cls + 20 loc + angle + 300 size + 10 corner, on one process (no
data-parallel reductions)."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.reference.boxes import boxes3d_to_bev, boxes3d_to_corners3d
from benchmark.reference.iou3d import _overlap_pairs


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def batch_any(mask: torch.Tensor) -> torch.Tensor:
    return torch.any(mask)


def sigmoid_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Stable BCE with logits: max(x, 0) - x*z + log1p(exp(-|x|))."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise Huber with beta = 1."""
    d = torch.abs(pred - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of x over the rows where mask is True (the mask broadcasts over
    x's trailing axes and the count counts broadcast elements); 0 when the
    mask is empty."""
    m = mask.to(x.dtype)
    while m.dim() < x.dim():
        m = m[..., None]
    m = m.expand(x.shape)
    return batch_sum(torch.sum(x * m)) / torch.clamp(batch_sum(torch.sum(m)),
                                                     min=1.0)


def softmax_cross_entropy_int(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy with integer labels, no reduction."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def _pick(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """pred (P, n), label (P,) int -> pred[p, label[p]]."""
    return torch.gather(pred, 1, label[:, None])[:, 0]


def rcnn_reg_loss(pred_reg: torch.Tensor, reg_label: torch.Tensor,
                  fg_mask: torch.Tensor, anchor_size: torch.Tensor,
                  loc_scope: float, loc_bin_size: float, num_head_bin: int,
                  get_xz_fine: bool = False, get_y_by_bin: bool = False,
                  loc_y_scope: float = 0.5, loc_y_bin_size: float = 0.25,
                  get_ry_fine: bool = False):
    """(loc, angle, size) losses over the foreground rows.

    pred_reg (P, 52), reg_label (P, 7) [x, y, z, h, w, l, ry] in the crop
    frame. The shipped config (LOC_XZ_FINE False) takes smooth-L1 on the
    first x/z residual slots and MSE on the y offset; the bin branches are
    the flags' other sides."""
    n = int((loc_scope + 1e-3) / loc_bin_size) * 2
    x_res_l, z_res_l, start = 2 * n, 3 * n, 4 * n
    loc_loss = 0.0
    if get_xz_fine:
        for axis, lo, res_lo in ((0, 0, x_res_l), (2, n, z_res_l)):
            shift = torch.clamp(reg_label[:, axis] + loc_scope, 0.0,
                                loc_scope * 2 - 1e-3)
            bin_label = torch.floor(shift / loc_bin_size).to(torch.int64)
            ce = softmax_cross_entropy_int(pred_reg[:, lo:lo + n], bin_label)
            loc_loss = loc_loss + masked_mean(ce, fg_mask)
            res = shift - (bin_label.to(shift.dtype) * loc_bin_size
                           + loc_bin_size / 2)
            pred_res = _pick(pred_reg[:, res_lo:res_lo + n], bin_label)
            loc_loss = loc_loss + masked_mean(
                smooth_l1(pred_res, res / (loc_bin_size / 2)), fg_mask)
    else:
        loc_loss = loc_loss + masked_mean(
            smooth_l1(pred_reg[:, x_res_l], reg_label[:, 0] / loc_scope),
            fg_mask)
        loc_loss = loc_loss + masked_mean(
            smooth_l1(pred_reg[:, z_res_l], reg_label[:, 2] / loc_scope),
            fg_mask)

    if get_y_by_bin:
        ny = int((loc_y_scope + 1e-3) / loc_y_bin_size) * 2
        y_shift = torch.clamp(reg_label[:, 1] + loc_y_scope, 0.0,
                              loc_y_scope * 2 - 1e-3)
        y_bin = torch.floor(y_shift / loc_y_bin_size).to(torch.int64)
        ce = softmax_cross_entropy_int(pred_reg[:, start:start + ny], y_bin)
        y_res = y_shift - (y_bin.to(y_shift.dtype) * loc_y_bin_size
                           + loc_y_bin_size / 2)
        pred_res = _pick(pred_reg[:, start + ny:start + 2 * ny], y_bin)
        loc_loss = loc_loss + masked_mean(ce, fg_mask) + masked_mean(
            smooth_l1(pred_res, y_res / loc_y_bin_size), fg_mask)
        start = start + 2 * ny
    else:
        y_err = pred_reg[:, start] - reg_label[:, 1]
        loc_loss = loc_loss + masked_mean(y_err * y_err, fg_mask)
        start = start + 1

    ry_label = reg_label[:, 6]
    if get_ry_fine:
        per = math.pi / num_head_bin
        ang = torch.clamp(ry_label % math.pi, 1e-3, math.pi - 1e-3)
        ry_bin = torch.floor(ang / per).to(torch.int64)
        ry_res = ang - (ry_bin.to(ang.dtype) * per + per / 2)
    else:
        per = 2 * math.pi / num_head_bin
        shift = (ry_label % (2 * math.pi) + per / 2) % (2 * math.pi)
        ry_bin = torch.floor(shift / per).to(torch.int64)
        ry_res = shift - (ry_bin.to(shift.dtype) * per + per / 2)
    ce = softmax_cross_entropy_int(pred_reg[:, start:start + num_head_bin],
                                   ry_bin)
    pred_res = _pick(pred_reg[:, start + num_head_bin:
                              start + 2 * num_head_bin], ry_bin)
    angle_loss = masked_mean(ce, fg_mask) + masked_mean(
        smooth_l1(pred_res, ry_res / (per / 2)), fg_mask)
    start = start + 2 * num_head_bin

    size_label = (reg_label[:, 3:6] - anchor_size) / anchor_size
    size_loss = masked_mean(smooth_l1(pred_reg[:, start:start + 3],
                                      size_label), fg_mask)
    return loc_loss, angle_loss, size_loss


def corner_loss(pred_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 of the corner distance to the gt box or to it turned by
    pi, whichever is nearer. pred_boxes, gt_boxes (P, 7) bottom-y."""
    pred_c = boxes3d_to_corners3d(pred_boxes)
    gt_c = boxes3d_to_corners3d(gt_boxes)
    flip = gt_boxes.clone()
    flip[:, 6] = flip[:, 6] + math.pi
    gt_fc = boxes3d_to_corners3d(flip)
    dist = torch.minimum(torch.linalg.norm(pred_c - gt_c, dim=-1),
                         torch.linalg.norm(pred_c - gt_fc, dim=-1))
    return masked_mean(smooth_l1(dist, torch.zeros_like(dist)), mask)


def pairwise_diag_iou3d(pred_boxes: torch.Tensor,
                        gt_boxes: torch.Tensor) -> torch.Tensor:
    """Row-wise 3D IoU of aligned (P, 7) bottom-y boxes."""
    overlap = _overlap_pairs(boxes3d_to_bev(pred_boxes),
                             boxes3d_to_bev(gt_boxes))
    a_min, a_max = pred_boxes[:, 1] - pred_boxes[:, 3], pred_boxes[:, 1]
    b_min, b_max = gt_boxes[:, 1] - gt_boxes[:, 3], gt_boxes[:, 1]
    h = torch.clamp(torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min),
                    min=0.0)
    inter = overlap * h
    vol_a = pred_boxes[:, 3] * pred_boxes[:, 4] * pred_boxes[:, 5]
    vol_b = gt_boxes[:, 3] * gt_boxes[:, 4] * gt_boxes[:, 5]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-7)


def rcnn_loss(rcnn_cls: torch.Tensor, rcnn_reg: torch.Tensor,
              pred_boxes3d: torch.Tensor, gt_boxes: torch.Tensor,
              cls_label: torch.Tensor, anchor_size: torch.Tensor,
              loc_scope: float = 1.5, loc_bin_size: float = 0.5,
              num_head_bin: int = 12, get_xz_fine: bool = False
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-2 loss: BCE cls + 20 loc + angle + 300 size + 10 corner.

    rcnn_cls (B,), rcnn_reg (B, 52), pred_boxes3d (B, 7) decoded and
    detached, gt_boxes (B, 7) in the crop frame, cls_label (B,) 0/1."""
    B = rcnn_reg.shape[0]
    fg_mask = cls_label > 0
    loss_loc, loss_angle, loss_size = rcnn_reg_loss(
        rcnn_reg.reshape(B, -1), gt_boxes.reshape(B, 7), fg_mask,
        anchor_size, loc_scope, loc_bin_size, num_head_bin,
        get_xz_fine=get_xz_fine)

    iou3d = pairwise_diag_iou3d(pred_boxes3d, gt_boxes).detach()
    iou_mask = fg_mask & (iou3d > 0.5)
    loss_corner = corner_loss(pred_boxes3d, gt_boxes, iou_mask)

    bce = sigmoid_cross_entropy(rcnn_cls.reshape(-1), cls_label)
    valid = (cls_label >= 0).to(bce.dtype)
    loss_cls = batch_sum(torch.sum(bce * valid)) / torch.clamp(
        batch_sum(torch.sum(valid)), min=1.0)

    has_fg = batch_any(fg_mask)
    zero = torch.zeros((), dtype=bce.dtype, device=bce.device)
    loss_loc = torch.where(has_fg, loss_loc, zero) * 20.0
    loss_angle = torch.where(has_fg, loss_angle, zero)
    loss_size = torch.where(has_fg, loss_size, zero) * 300.0
    loss_corner = torch.where(has_fg, loss_corner, zero) * 10.0

    total = loss_cls + loss_loc + loss_angle + loss_size + loss_corner
    aux = {"rcnn_loss_cls": loss_cls, "rcnn_loss_loc": loss_loc,
           "rcnn_loss_angle": loss_angle, "rcnn_loss_size": loss_size,
           "rcnn_loss_corner": loss_corner, "rcnn_loss": total,
           "rcnn_iou_mean": masked_mean(iou3d, fg_mask),
           # logged, not added to the total, as in the reference
           "rcnn_loss_giou": masked_mean(1.0 - iou3d, iou_mask)}
    return total, aux
