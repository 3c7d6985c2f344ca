"""Greedy suppression sweep (port of ws3d_tpu/ops/nms.py:_greedy_suppress),
batched over a leading axis."""
from __future__ import annotations

import torch


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
