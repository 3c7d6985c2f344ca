"""Furthest point sampling + point gathering (kernel 1: csrc/fps.cu).

Port of ws3d_tpu/ops/sampling.py. FPS seeds with index 0, keeps a min-d2
cache starting at 1e10 and picks the argmax with the lowest index winning
ties; the CUDA kernel also emits the picked coordinates.
"""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops import _kernels


def fps_plain(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Plain version: xyz (R, N, 3) f32 -> (R, npoint) int32 indices."""
    R, N, _ = xyz.shape
    idx = torch.zeros((R, npoint), dtype=torch.int32, device=xyz.device)
    min_d2 = torch.full((R, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(R, device=xyz.device)
    last = torch.zeros(R, dtype=torch.long, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for i in range(1, npoint):
        lp = xyz[rows, last]                                   # (R, 3)
        dx = x - lp[:, 0:1]
        dy = y - lp[:, 1:2]
        dz = z - lp[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=-1)                    # first max
        idx[:, i] = last.to(torch.int32)
    return idx


def fps_cuda(xyz: torch.Tensor, npoint: int):
    """Kernel 1: xyz (R, N, 3) f32 CUDA -> (idx (R, npoint) int32,
    coords (R, npoint, 3) f32). Rows of up to 1,024 points run one warp a
    row, larger rows a thread-block cluster a row."""
    _kernels.check_cuda(xyz, "fps xyz", torch.float32, (None, None, 3))
    R, N, _ = xyz.shape
    idx = torch.empty((R, npoint), dtype=torch.int32, device=xyz.device)
    coords = torch.empty((R, npoint, 3), dtype=torch.float32,
                         device=xyz.device)
    _kernels.launch(
        "fps", "ws3d_fps", xyz.data_ptr(), R, N, int(npoint), idx.data_ptr(),
        coords.data_ptr(), _kernels.stream_ptr(xyz))
    return idx, coords


def furthest_point_sample_with_coords(xyz: torch.Tensor, npoint: int):
    """xyz (B, N, 3) -> (idx (B, npoint) int32, coords (B, npoint, 3) f32)."""
    if npoint <= 1:
        npoint = max(npoint, 1)
        idx = torch.zeros((xyz.shape[0], npoint), dtype=torch.int32,
                          device=xyz.device)
        return idx, xyz[:, :1, :3].expand(-1, npoint, -1).float()
    if xyz.is_cuda:
        return fps_cuda(xyz, npoint)
    idx = fps_plain(xyz, npoint)
    return idx, gather_points(xyz[..., :3], idx).float()


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, M) -> (B, M, C)."""
    return torch.gather(points, 1, idx.long()[..., None].expand(
        -1, -1, points.shape[-1]))
