"""Greedy NMS over fixed-size candidate sets with validity masks (port of
ws3d_tpu/ops/nms.py): the greedy sweep, rotated / axis-aligned BEV NMS,
radius NMS on centre votes and the score-threshold top-k. Each works on
(..., K) candidates, batched over leading axes."""
from __future__ import annotations

from typing import Optional

import torch

from ws3d_tpu_torch.ops.iou3d import aligned_overlap_bev, boxes_iou_bev


def greedy_suppress(pair_mat: torch.Tensor, thresh: float,
                    valid: torch.Tensor) -> torch.Tensor:
    """Greedy sweep over rows already sorted by descending score.

    pair_mat (..., K, K), valid (..., K) bool -> keep (..., K) bool: i is
    kept iff valid and no kept j < i has pair_mat[j, i] > thresh.
    """
    K = pair_mat.shape[-1]
    suppress = pair_mat > thresh
    keep = torch.zeros_like(valid)
    for i in range(K):
        killed = torch.any(keep[..., :i] & suppress[..., :i, i], dim=-1)
        keep[..., i] = valid[..., i] & ~killed
    return keep


def _score_order(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Rank -> index by descending score, invalid rows last; equal scores
    keep their index order (jnp.argsort is stable)."""
    neg = torch.where(valid, scores, -torch.inf)
    return torch.argsort(-neg, dim=-1, stable=True)


def _take(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """x (..., K, C) or (..., K) rows in `order` (..., K)."""
    if x.dim() == order.dim():
        return torch.gather(x, -1, order)
    return torch.gather(x, -2, order[..., None].expand(order.shape
                                                        + x.shape[-1:]))


def rotated_nms(bev: torch.Tensor, scores: torch.Tensor, thresh: float,
                valid: Optional[torch.Tensor] = None, rotated: bool = True):
    """Greedy BEV NMS: bev (..., K, 5), scores (..., K) -> (keep (..., K)
    bool, order (..., K)), both in score order: `order` maps rank to the
    original index. rotated=False uses the axis-aligned IoU."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    order = _score_order(scores, valid)
    bev_s = _take(bev, order)
    iou = (boxes_iou_bev(bev_s, bev_s) if rotated
           else aligned_overlap_bev(bev_s, bev_s))
    return greedy_suppress(iou, thresh, _take(valid, order)), order


def radius_nms(centers_xz: torch.Tensor, scores: torch.Tensor,
               radius: float, valid: Optional[torch.Tensor] = None):
    """Greedy BEV radius NMS on centre votes: a candidate is kept iff no
    higher-scoring kept centre lies strictly within `radius`. centers_xz
    (..., K, 2) -> (keep, order) in score order. Distances by explicit
    differences, never a matmul."""
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool,
                           device=scores.device)
    order = _score_order(scores, valid)
    c = _take(centers_xz, order)
    diff = c[..., :, None, :] - c[..., None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return greedy_suppress(-(dist - radius), 0.0, _take(valid, order)), order


def score_threshold_topk(scores: torch.Tensor, thresh: float, k: int,
                         valid: Optional[torch.Tensor] = None):
    """The top-k scores (..., K) -> (idx (..., k) into the original array,
    ok (..., k) bool: the slot's score is above `thresh`). Equal scores
    rank the lower index first, as lax.top_k does (torch.topk makes no
    promise on ties, so this sorts stably)."""
    if valid is not None:
        scores = torch.where(valid, scores, -torch.inf)
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return idx[..., :k], top[..., :k] > thresh
