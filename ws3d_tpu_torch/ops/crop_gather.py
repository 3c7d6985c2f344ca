"""Fused cylinder crop-gather (kernel 5: csrc/crop_gather.cu).

Port of ws3d_tpu/ops/ball_query_pallas.py:crop_gather_pallas in full mode:
BEV (x, z) membership at radius r over all N points, the first min(cnt, k)
members in index order, the slot -> member map (grouped duplicates or
`s % cnt`), and an exact gather of the channels. Empty crops give zeros.
"""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.grouping import first_k_true_indices, radius_sq


def slot_members(cnt: torch.Tensor, k: int, grouped: bool) -> torch.Tensor:
    """cnt (...,) int -> (..., k) member rank j(s) for each slot s."""
    s = torch.arange(k, device=cnt.device)
    c = torch.clamp(cnt.long(), min=1)[..., None]
    if grouped:
        Q = k // c
        R = k % c
        thresh = R * (Q + 1)
        j = torch.where(s < thresh, s // (Q + 1),
                        R + (s - thresh) // torch.clamp(Q, min=1))
    else:
        j = s % c
    return torch.where(c >= k, s, j)


def crop_gather_plain(xyz: torch.Tensor, channels: torch.Tensor,
                      centers_xz: torch.Tensor, radius: float, k: int,
                      grouped: bool = True):
    """Plain version: xyz (B, N, 3), channels (B, C, N), centers (B, M, 2)
    -> (vals (C, B, M, k) f32, cnt (B, M) int32)."""
    B, N, _ = xyz.shape
    dx = centers_xz[..., 0:1] - xyz[:, None, :, 0]
    dz = centers_xz[..., 1:2] - xyz[:, None, :, 2]
    member = dx * dx + dz * dz < radius_sq(radius, xyz.device)  # (B, M, N)
    cnt = member.sum(-1)
    kk = min(k, N)
    first = first_k_true_indices(member, kk)                   # (B, M, kk)
    j = torch.clamp(slot_members(cnt, k, grouped), max=kk - 1)
    idx = torch.gather(first, -1, j).clamp(max=N - 1)          # (B, M, k)
    M = centers_xz.shape[1]
    C = channels.shape[1]
    vals = torch.gather(channels[:, :, None, :].expand(B, C, M, N), -1,
                        idx[:, None].expand(B, C, M, k))
    vals = torch.where((cnt == 0)[:, None, :, None], 0.0, vals)
    return vals.permute(1, 0, 2, 3).contiguous(), cnt.to(torch.int32)


def crop_gather_cuda(xyz: torch.Tensor, channels: torch.Tensor,
                     centers_xz: torch.Tensor, radius: float, k: int,
                     grouped: bool = True):
    """Kernel 5 on CUDA tensors; same contract as crop_gather_plain."""
    B, N, _ = xyz.shape
    M = centers_xz.shape[1]
    C = channels.shape[1]
    _kernels.check_cuda(xyz, "crop xyz", torch.float32, (B, N, 3))
    _kernels.check_cuda(channels, "crop channels", torch.float32, (B, C, N))
    _kernels.check_cuda(centers_xz, "crop centers", torch.float32, (B, M, 2))
    vals = torch.empty((C, B, M, k), dtype=torch.float32, device=xyz.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz.device)
    r = float(radius)
    rc = _kernels.library().ws3d_crop_gather(
        xyz.data_ptr(), channels.data_ptr(), centers_xz.data_ptr(), B, N, C,
        M, int(k), r * r, int(bool(grouped)), vals.data_ptr(), cnt.data_ptr(),
        _kernels.stream_ptr(xyz))
    _kernels.raise_on_error(rc, "crop_gather")
    _kernels.LAUNCHES["crop_gather"] += 1
    return vals, cnt


def crop_gather(xyz, channels, centers_xz, radius: float, k: int,
                grouped: bool = True):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if xyz.is_cuda:
        return crop_gather_cuda(xyz, channels, centers_xz, radius, k, grouped)
    return crop_gather_plain(xyz, channels, centers_xz, radius, k, grouped)
