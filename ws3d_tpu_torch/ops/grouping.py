"""Ball query + grouping, plain PyTorch (port of ws3d_tpu/ops/grouping.py).

Semantics: for each query the first ``nsample`` points with d2 < r2
(strict) in ascending index order, padded with the first hit; a query with
no point in its ball gets index 0 everywhere. Distances are the direct
(dx^2 + dy^2 + dz^2) form, never a matmul or ``cdist``.
"""
from __future__ import annotations

from typing import Optional

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, 3), b (..., N, 3) -> (..., M, N) squared distances."""
    d = None
    for c in range(3):
        dc = a[..., :, None, c] - b[..., None, :, c]
        d = dc * dc if d is None else d + dc * dc
    return d


def first_k_true_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """mask (..., N) bool -> (..., k) int64: positions of the first k True
    entries in ascending order; slots past the count hold N."""
    rank = torch.cumsum(mask, dim=-1)
    targets = torch.arange(1, k + 1, device=mask.device, dtype=rank.dtype)
    return torch.searchsorted(
        rank, targets.expand(mask.shape[:-1] + (k,)).contiguous(), side="left")


def select_in_ball(d2: torch.Tensor, r2: torch.Tensor,
                   nsample: int) -> torch.Tensor:
    """d2 (..., N) -> (..., nsample) first-k in-ball indices, pad with the
    first hit, 0 on empty."""
    N = d2.shape[-1]
    idx = first_k_true_indices(d2 < r2, nsample)
    first = idx[..., 0:1]
    idx = torch.where(idx < N, idx, first)
    return torch.where(first < N, idx, torch.zeros_like(idx))


def radius_sq(radius: float, device) -> torch.Tensor:
    """r^2 rounded once to f32, as the JAX package's weakly typed scalar."""
    return torch.tensor(float(radius) * float(radius), dtype=torch.float32,
                        device=device)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor, chunk: int = 512) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, M, 3) -> (B, M, nsample) int32: one scale
    of the multi-scale query, kernel 6 on CUDA tensors, on CPU tensors its
    plain version chunked over the queries to bound the (B, chunk, N)
    distance block."""
    from ws3d_tpu_torch.ops import ball_query as bq
    if xyz.is_cuda:
        return bq.ball_query_multi_cuda([radius], [nsample], xyz, new_xyz)[0]
    return bq.ball_query_multi_plain([radius], [nsample], xyz, new_xyz,
                                     chunk)[0]


def ball_query_multi(radii, nsamples, xyz: torch.Tensor,
                     new_xyz: torch.Tensor):
    """Per-scale first-k in-ball indices, (B, M, nsamples[i]) int32 each:
    kernel 6 on CUDA tensors, its plain version on CPU tensors."""
    from ws3d_tpu_torch.ops import ball_query as bq
    if xyz.is_cuda:
        return bq.ball_query_multi_cuda(radii, nsamples, xyz, new_xyz)
    return bq.ball_query_multi_plain(radii, nsamples, xyz, new_xyz)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M, S) -> (B, M, S, C)."""
    B, M, S = idx.shape
    flat = idx.reshape(B, M * S, 1).expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, flat).reshape(B, M, S, points.shape[-1])


def group_with_idx(idx: torch.Tensor, xyz: torch.Tensor,
                   new_xyz: torch.Tensor,
                   features: Optional[torch.Tensor]) -> torch.Tensor:
    """idx (B, M, S) int64 -> (B, M, S, 3 + C): centre-relative xyz concat
    features (none without features). Differentiable in `features`
    (gather's backward scatter-adds) and through the centre subtraction."""
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is None:
        return grouped_xyz
    return torch.cat([grouped_xyz, group_points(features, idx)], dim=-1)


def group_all(xyz: torch.Tensor,
              features: Optional[torch.Tensor]) -> torch.Tensor:
    """GroupAll: one group of all points -> (B, 1, N, 3 + C)."""
    if features is None:
        return xyz[:, None]
    return torch.cat([xyz[:, None], features[:, None]], dim=-1)
