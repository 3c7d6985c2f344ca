"""Stage-1 (RPN) and stage-2 (RCNN, IOUN) losses: port of
ws3d_tpu/losses.py.

Fixed-shape and mask-based: a loss the reference takes over a foreground
subset is a masked mean over the whole batch, and a loss with no foreground
row is zero (the `has_fg` gates). The IoU targets are detached, as the JAX
package stops their gradient.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ws3d_tpu_torch.ops.boxes import boxes3d_to_bev, boxes3d_to_corners3d
from ws3d_tpu_torch.ops.iou3d import _overlap_pairs


def sigmoid_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Stable BCE with logits: max(x, 0) - x*z + log1p(exp(-|x|))."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss * weights; `targets` may be soft."""
    ce = sigmoid_cross_entropy(logits, targets)
    p = torch.sigmoid(logits)
    p_t = targets * p + (1.0 - targets) * (1.0 - p)
    modulating = torch.pow(1.0 - p_t, gamma) if gamma else 1.0
    alpha_w = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return modulating * alpha_w * ce * weights


def dice_loss(logits: torch.Tensor, target: torch.Tensor,
              ignore_target: float = -1.0) -> torch.Tensor:
    """Soft-IoU Dice loss on sigmoid scores: 1 - sum(min(x, t)) /
    max(sum(max(x, t)), 1) over the entries whose target is not
    `ignore_target`."""
    x = torch.sigmoid(logits.reshape(-1))
    t = target.reshape(-1).to(x.dtype)
    mask = (t != ignore_target).to(x.dtype)
    num = torch.sum(torch.minimum(x, t) * mask)
    den = torch.clamp(torch.sum(torch.maximum(x, t) * mask), min=1.0)
    return 1.0 - num / den


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
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def softmax_cross_entropy_int(logits: torch.Tensor,
                              labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross entropy with integer labels, no reduction."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None].long())[..., 0]


def rpn_reg_loss(pred_reg: torch.Tensor, reg_label: torch.Tensor,
                 fg_mask: torch.Tensor, loc_scope: float,
                 loc_bin_size: float) -> torch.Tensor:
    """Bin-based (x, z) centre-vote regression loss over the foreground.

    pred_reg (P, 4 * n_bins), reg_label (P, 3) [dx, 0, dz], fg_mask (P,)."""
    n = int((loc_scope + 1e-3) / loc_bin_size) * 2
    loss = 0.0
    for axis, lo in ((0, 0), (2, n)):
        off = reg_label[:, axis]
        shift = torch.clamp(off + loc_scope, 0.0, loc_scope * 2 - 1e-3)
        bin_label = torch.floor(shift / loc_bin_size).to(torch.int64)
        ce = softmax_cross_entropy_int(pred_reg[:, lo:lo + n], bin_label)
        loss = loss + masked_mean(ce, fg_mask)
        res = shift - (bin_label.to(shift.dtype) * loc_bin_size
                       + loc_bin_size / 2)
        res_norm = res / (loc_bin_size / 2)
        res_slot = 2 * n + lo
        pred_res = torch.gather(pred_reg[:, res_slot:res_slot + n], 1,
                                bin_label[:, None])[:, 0]
        loss = loss + masked_mean(smooth_l1(pred_res, res_norm), fg_mask)
    return loss


def rpn_loss(rpn_cls: torch.Tensor, rpn_reg: torch.Tensor,
             cls_label: torch.Tensor, reg_label: torch.Tensor,
             loc_scope: float, loc_bin_size: float,
             focal_alpha: float = 0.25, focal_gamma: float = 2.0,
             loss_weights=(1.0, 1.0)
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Stage-1 loss on Gaussian soft labels: focal cls + bin reg.

    rpn_cls (B, N, 1), rpn_reg (B, N, C), cls_label (B, N) in [0, 1],
    reg_label (B, N, 3) -> (total, aux). The aux values stay on the device
    (reading them waits for it)."""
    logits = rpn_cls.reshape(-1)
    target = cls_label.reshape(-1)
    pos = target
    neg = 1.0 - target
    weights = (pos + neg) / torch.clamp(torch.sum(pos), min=1.0)
    cls_elem = sigmoid_focal_loss(logits, target, weights,
                                  alpha=focal_alpha, gamma=focal_gamma)
    loss_cls = torch.sum(cls_elem)

    # XLA on the CPU and the TPU flushes denormals to zero, so a Gaussian
    # label that underflowed to a denormal is background in the JAX package
    fg_mask = target >= torch.finfo(target.dtype).tiny
    P = logits.shape[0]
    loss_reg = rpn_reg_loss(rpn_reg.reshape(P, -1), reg_label.reshape(P, 3),
                            fg_mask, loc_scope, loc_bin_size)
    loss_reg = torch.where(torch.any(fg_mask), loss_reg,
                           torch.zeros_like(loss_reg))
    total = loss_cls * loss_weights[0] + loss_reg * loss_weights[1]
    aux = {"rpn_loss_cls": loss_cls, "rpn_loss_reg": loss_reg,
           "rpn_fg_sum": torch.sum(fg_mask.to(torch.int32)),
           "rpn_loss": total}
    return total, aux


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
    loss_cls = torch.sum(bce * valid) / torch.clamp(torch.sum(valid), min=1.0)

    has_fg = torch.any(fg_mask)
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


def ioun_loss(rcnn_iou: torch.Tensor, rcnn_ref: torch.Tensor,
              pred_boxes3d: torch.Tensor, refined_boxes3d: torch.Tensor,
              gt_boxes: torch.Tensor, cls_label: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """IOUN cascade loss: 100 range-masked MSE(iou_pred, iou(refined, gt)^2)
    + 300 smooth-L1 loc/size (over the predicted dims) + 20 angle residual.

    rcnn_iou (B, 1) or (B,), rcnn_ref (B, 7); boxes (B, 7); cls_label (B,)."""
    fg_mask = cls_label > 0
    loc_pred, siz_pred, ang_pred = (pred_boxes3d[:, :3], pred_boxes3d[:, 3:6],
                                    pred_boxes3d[:, 6])
    loc_l, siz_l, ang_l = gt_boxes[:, :3], gt_boxes[:, 3:6], gt_boxes[:, 6]

    safe_siz = torch.where(torch.abs(siz_pred) > 1e-6, siz_pred,
                           torch.ones_like(siz_pred))
    loss_loc = masked_mean(smooth_l1(rcnn_ref[:, :3],
                                     (loc_l - loc_pred) / safe_siz),
                           fg_mask) * 300.0
    loss_siz = masked_mean(smooth_l1(rcnn_ref[:, 3:6],
                                     (siz_l - siz_pred) / safe_siz),
                           fg_mask) * 300.0
    ang_res = (ang_l % math.pi) - (ang_pred % math.pi)
    loss_ang = masked_mean(smooth_l1(rcnn_ref[:, 6], ang_res),
                           fg_mask) * 20.0

    iou3d = pairwise_diag_iou3d(refined_boxes3d, gt_boxes).detach()
    iou_label = iou3d * iou3d
    range_mask = torch.sum(gt_boxes, dim=-1) != 0
    err = rcnn_iou.reshape(-1) - iou_label
    loss_iou = masked_mean(err * err, range_mask) * 100.0

    has_fg = torch.any(fg_mask)
    zero = torch.zeros((), dtype=err.dtype, device=err.device)
    loss_loc = torch.where(has_fg, loss_loc, zero)
    loss_siz = torch.where(has_fg, loss_siz, zero)
    loss_ang = torch.where(has_fg, loss_ang, zero)

    total = loss_iou + loss_loc + loss_siz + loss_ang
    aux = {"loss_iou": loss_iou, "ioun_loss_loc": loss_loc,
           "ioun_loss_siz": loss_siz, "ioun_loss_ang": loss_ang,
           "rcnn_loss_iou": total}
    return total, aux
