"""Legacy top-N proposal selection (port of
ws3d_tpu/pipeline/proposal_layer.py): score- or distance-based pre-NMS
top-N, oriented or axis-aligned BEV NMS at cfg[mode].RPN_NMS_THRESH, then
post-NMS top-N, over fixed shapes with validity masks. The shipped flow
proposes through rpn_propose instead; this stays callable for the
RPN_PRE/POST_NMS_TOP_N, RPN_NMS_THRESH, RPN.NMS_TYPE and
RPN_DISTANCE_BASED_PROPOSE knobs. Ties rank the lower index first, as
lax.top_k does.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import torch

from ws3d_tpu_torch.ops.boxes import boxes3d_to_bev
from ws3d_tpu_torch.ops.nms import rotated_nms
from ws3d_tpu_torch.pipeline.inference import top_k


def _select(scores, boxes, keep_sorted, order, top_n: int):
    """The top `top_n` kept entries (sorted space) -> fixed slots, their
    scores and validity."""
    rank_score = torch.where(keep_sorted, scores[order], -torch.inf)
    top, rank_idx = top_k(rank_score, top_n)
    sel = order[rank_idx]
    valid = torch.isfinite(top)
    return (torch.where(valid[:, None], boxes[sel], 0.0),
            torch.where(valid, scores[sel], 0.0), valid)


def _region(scores, boxes3d, mask, pre: int, post: int, nms_thresh: float,
            rotated: bool):
    top, idx = top_k(torch.where(mask, scores, -torch.inf), pre)
    cand = boxes3d[idx]
    keep, order = rotated_nms(boxes3d_to_bev(cand), top, nms_thresh,
                              valid=torch.isfinite(top), rotated=rotated)
    return _select(top, cand, keep, order, post)


def score_based_proposal(scores: torch.Tensor, boxes3d: torch.Tensor,
                         pre_top_n: int, post_top_n: int, nms_thresh: float,
                         rotated: bool = True,
                         valid: Optional[torch.Tensor] = None):
    """One scene: scores (N,), boxes3d (N, 7) -> (boxes (post, 7),
    scores (post,), valid (post,)): pre-NMS top-N by score, BEV NMS, post-NMS
    top-N."""
    pre = min(int(pre_top_n), scores.shape[0])
    mask = (torch.ones_like(scores, dtype=torch.bool) if valid is None
            else valid)
    return _region(scores, boxes3d, mask, pre, min(int(post_top_n), pre),
                   nms_thresh, rotated)


def distance_based_proposal(scores: torch.Tensor, boxes3d: torch.Tensor,
                            pre_top_n: int, post_top_n: int,
                            nms_thresh: float, rotated: bool = True,
                            valid: Optional[torch.Tensor] = None):
    """Two regions: 0-40 m takes 70 % of the pre and post budgets, 40-80 m
    the rest; each runs its own BEV NMS and the kept sets are
    concatenated."""
    N = scores.shape[0]
    pre_n = [int(pre_top_n * 0.7), int(pre_top_n) - int(pre_top_n * 0.7)]
    post_n = [int(post_top_n * 0.7), int(post_top_n) - int(post_top_n * 0.7)]
    ok = torch.ones_like(scores, dtype=torch.bool) if valid is None else valid
    outs = []
    for (lo, hi), pre, post in zip(((0.0, 40.0), (40.0, 80.0)), pre_n,
                                   post_n):
        pre = min(pre, N)
        in_rng = ok & (boxes3d[:, 2] > lo) & (boxes3d[:, 2] <= hi)
        outs.append(_region(scores, boxes3d, in_rng, pre, min(post, pre),
                            nms_thresh, rotated))
    return tuple(torch.cat([o[i] for o in outs], dim=0) for i in range(3))


def make_proposal_fn(cfg, mode: str = "TEST"):
    """fn(scores (B, N), boxes3d (B, N, 7)) -> (boxes (B, M, 7),
    scores (B, M), valid (B, M)), M = cfg[mode].RPN_POST_NMS_TOP_N, from
    cfg[mode].RPN_PRE/POST_NMS_TOP_N, RPN_NMS_THRESH,
    RPN_DISTANCE_BASED_PROPOSE and cfg.RPN.NMS_TYPE."""
    m = cfg[mode]
    nms_type = str(cfg.RPN.NMS_TYPE)
    if nms_type not in ("normal", "rotate"):
        raise NotImplementedError(f"RPN.NMS_TYPE {nms_type!r}")
    base = (distance_based_proposal if bool(m.RPN_DISTANCE_BASED_PROPOSE)
            else score_based_proposal)
    one = partial(base, pre_top_n=int(m.RPN_PRE_NMS_TOP_N),
                  post_top_n=int(m.RPN_POST_NMS_TOP_N),
                  nms_thresh=float(m.RPN_NMS_THRESH),
                  rotated=nms_type == "rotate")

    def fn(scores: torch.Tensor, boxes3d: torch.Tensor):
        outs = [one(s, b) for s, b in zip(scores, boxes3d)]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))
    return fn
