"""Greedy NMS over fixed-size candidate sets with validity masks (port of
ws3d_tpu/ops/nms.py): the greedy sweep, rotated / axis-aligned BEV NMS,
radius NMS on centre votes and the score-threshold top-k. Each works on
(..., K) candidates, batched over leading axes."""
from __future__ import annotations

from typing import Optional

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.iou3d import aligned_overlap_bev, boxes_iou_bev
from ws3d_tpu_torch.utils.profiling import count, span


def greedy_suppress_plain(pair_mat: torch.Tensor, thresh: float,
                          valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the sweep kernel: a K-step loop."""
    suppress = pair_mat > thresh
    keep = torch.zeros_like(valid)
    for i in range(pair_mat.shape[-1]):
        killed = torch.any(keep[..., :i] & suppress[..., :i, i], dim=-1)
        keep[..., i] = valid[..., i] & ~killed
    return keep


def greedy_suppress_cuda(pair_mat: torch.Tensor, thresh: float,
                         valid: torch.Tensor) -> torch.Tensor:
    """The sweep kernel (csrc/nms.cu), one launch for every leading row:
    pair_mat (..., K, K) f32, valid (..., K) bool CUDA -> keep (..., K)
    bool. The wrapper allocates the kernel's bitmask workspace, (R, K,
    ceil(K / 32)) words."""
    K = pair_mat.shape[-1]
    lead = tuple(pair_mat.shape[:-2])
    _kernels.check_cuda(pair_mat, "greedy_sweep pair_mat", torch.float32,
                        lead + (K, K))
    _kernels.check_cuda(valid, "greedy_sweep valid", torch.bool, lead + (K,))
    keep = torch.empty_like(valid)
    if keep.numel() == 0:
        return keep
    R = keep.numel() // K
    mask = torch.empty((R, K, (K + 31) // 32), dtype=torch.int32,
                       device=pair_mat.device)
    _kernels.launch(
        "greedy_sweep", "ws3d_greedy_sweep", pair_mat.data_ptr(),
        valid.data_ptr(), thresh, R, K, mask.data_ptr(), keep.data_ptr(),
        _kernels.stream_ptr(pair_mat))
    return keep


@span("nms.sweep")
def greedy_suppress(pair_mat: torch.Tensor, thresh: float,
                    valid: torch.Tensor) -> torch.Tensor:
    """Greedy sweep over rows already sorted by descending score.

    pair_mat (..., K, K), valid (..., K) bool -> keep (..., K) bool: i is
    kept iff valid and no kept j < i has pair_mat[j, i] > thresh. The sweep
    kernel on CUDA tensors, the plain loop on CPU tensors; `nms.sweep_steps`
    counts the host-issued steps: 1 a launch, K a plain call.
    """
    if pair_mat.is_cuda:
        count("nms.sweep_steps", 1)
        return greedy_suppress_cuda(pair_mat, thresh, valid)
    count("nms.sweep_steps", pair_mat.shape[-1])
    return greedy_suppress_plain(pair_mat, thresh, valid)


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
