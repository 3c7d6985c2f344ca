"""Stage-1 (RPN) losses: port of the RPN part of ws3d_tpu/losses.py.

Fixed-shape and mask-based: a loss the reference takes over a foreground
subset is a masked mean over the whole batch. The RCNN and IOUN losses wait
for stage-2 training.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


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
