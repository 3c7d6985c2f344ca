"""Fused cylinder crop-gather (kernels 5 and 10: csrc/crop_gather.cu).

Port of ws3d_tpu/ops/ball_query_pallas.py:crop_gather_pallas: BEV (x, z)
membership at radius r, the first min(cnt, k) members in index order, the
slot -> member map (grouped duplicates or `s % cnt`), and an exact gather of
the channels. Empty crops give zeros. Kernel 5 tests, for every centre,
the 32-point chunks whose z range lies within r of it (exact: no member
lies elsewhere). Kernel 10 (its z-window mode, for clouds sorted ascending
by z) searches only the contiguous range of points whose own z term
fl((cz - pz)^2) is below r^2, which holds every member; a centre whose
range spans more than `z_window` 128-point tiles searches all N. The output
is the same either way.
"""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.grouping import first_k_true_indices, radius_sq

TILE = 128          # the TPU kernel's point tile: the unit of z_window


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


def _bev_member(xyz, centers_xz, r2):
    """(B, M, N) BEV membership, the kernels' term-rounded d2 < r2."""
    dx = centers_xz[..., 0:1] - xyz[:, None, :, 0]
    dz = centers_xz[..., 1:2] - xyz[:, None, :, 2]
    return dx * dx + dz * dz < r2


def _gather_members(member, channels, k: int, grouped: bool):
    """member (B, M, N) bool, channels (B, C, N) -> (vals (C, B, M, k),
    cnt (B, M) int32)."""
    B, M, N = member.shape
    C = channels.shape[1]
    cnt = member.sum(-1)
    kk = min(k, N)
    first = first_k_true_indices(member, kk)                   # (B, M, kk)
    j = torch.clamp(slot_members(cnt, k, grouped), max=kk - 1)
    idx = torch.gather(first, -1, j).clamp(max=N - 1)          # (B, M, k)
    vals = torch.gather(channels[:, :, None, :].expand(B, C, M, N), -1,
                        idx[:, None].expand(B, C, M, k))
    vals = torch.where((cnt == 0)[:, None, :, None], 0.0, vals)
    return vals.permute(1, 0, 2, 3).contiguous(), cnt.to(torch.int32)


def crop_gather_plain(xyz: torch.Tensor, channels: torch.Tensor,
                      centers_xz: torch.Tensor, radius: float, k: int,
                      grouped: bool = True):
    """Plain version of kernel 5: xyz (B, N, 3), channels (B, C, N),
    centers (B, M, 2) -> (vals (C, B, M, k) f32, cnt (B, M) int32)."""
    member = _bev_member(xyz, centers_xz, radius_sq(radius, xyz.device))
    return _gather_members(member, channels, k, grouped)


def z_windows(pz: torch.Tensor, cz: torch.Tensor, r2: torch.Tensor):
    """The candidate range [lo, hi) of each centre on clouds sorted by z:
    pz (B, N), cz (B, M) -> lo, hi (B, M) int64. Kernel 10's rule: binary
    searches on its own predicate fl((cz - pz)^2) < r2, which rises towards
    the centre's home (the first pz >= cz) and falls after it."""
    N = pz.shape[1]
    home = torch.searchsorted(pz.contiguous(), cz.contiguous(), side="left")

    def near(j):
        dz = cz - torch.gather(pz, 1, j.clamp(0, N - 1))
        return dz * dz < r2

    def search(a, e, want):
        """The first j in [a, e) with near(j) == want (e if none), for near
        monotone on [a, e)."""
        for _ in range(max(N, 1).bit_length()):
            live = a < e
            mid = (a + e) // 2
            hit = near(mid) == want
            e = torch.where(live & hit, mid, e)
            a = torch.where(live & ~hit, mid + 1, a)
        return a

    lo = search(torch.zeros_like(home), home, True)
    hi = search(home, torch.full_like(home, N), False)
    return lo, hi


def window_tiles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """The TILE-point tiles each range [lo, hi) touches (0 when empty)."""
    return torch.where(hi > lo, (hi - 1) // TILE - lo // TILE + 1, 0)


def crop_gather_window_plain(xyz: torch.Tensor, channels: torch.Tensor,
                             centers_xz: torch.Tensor, radius: float, k: int,
                             grouped: bool = True, z_window: int = 32):
    """Plain version of kernel 10 (xyz sorted ascending by z): the same
    contract as crop_gather_plain, membership searched over each centre's
    z-window, or over all N where the window spans more than `z_window`
    tiles."""
    r2 = radius_sq(radius, xyz.device)
    lo, hi = z_windows(xyz[..., 2], centers_xz[..., 1], r2)
    fits = window_tiles(lo, hi) <= int(z_window)
    lo = torch.where(fits, lo, 0)
    hi = torch.where(fits, hi, xyz.shape[1])
    pos = torch.arange(xyz.shape[1], device=xyz.device)
    scanned = (pos >= lo[..., None]) & (pos < hi[..., None])
    member = _bev_member(xyz, centers_xz, r2) & scanned
    return _gather_members(member, channels, k, grouped)


def crop_gather_cuda(xyz: torch.Tensor, channels: torch.Tensor,
                     centers_xz: torch.Tensor, radius: float, k: int,
                     grouped: bool = True, z_window: int | None = None):
    """Kernel 5 (z_window None) or kernel 10 (z_window W >= 1) on CUDA
    tensors; the contract of crop_gather_plain (crop_gather_window_plain
    for kernel 10). One launch after a pre-pass that writes the cloud's
    chunk z ranges into a workspace."""
    B, N, _ = xyz.shape
    M = centers_xz.shape[1]
    C = channels.shape[1]
    if z_window is not None and int(z_window) < 1:
        raise ValueError(f"crop_gather: z_window {z_window} (>= 1 tiles)")
    _kernels.check_cuda(xyz, "crop xyz", torch.float32, (B, N, 3))
    _kernels.check_cuda(channels, "crop channels", torch.float32, (B, C, N))
    _kernels.check_cuda(centers_xz, "crop centers", torch.float32, (B, M, 2))
    vals = torch.empty((C, B, M, k), dtype=torch.float32, device=xyz.device)
    cnt = torch.empty((B, M), dtype=torch.int32, device=xyz.device)
    bounds = _kernels.chunk_bounds_workspace(xyz)
    r = float(radius)
    rc = _kernels.library().ws3d_crop_gather(
        xyz.data_ptr(), channels.data_ptr(), centers_xz.data_ptr(), B, N, C,
        M, int(k), r * r, int(bool(grouped)),
        0 if z_window is None else int(z_window), vals.data_ptr(),
        cnt.data_ptr(), bounds.data_ptr(), _kernels.stream_ptr(xyz))
    key = "crop_gather" if z_window is None else "crop_gather_window"
    _kernels.raise_on_error(rc, key)
    _kernels.LAUNCHES[key] += 1
    return vals, cnt


def crop_gather(xyz, channels, centers_xz, radius: float, k: int,
                grouped: bool = True, z_window: int | None = None,
                center_z: torch.Tensor | None = None):
    """The kernels on CUDA tensors, the plain versions on CPU tensors.

    The dispatch rule of crop_gather_pallas: the z-window mode (kernel 10,
    xyz sorted ascending by z) only when both `z_window` and `center_z`
    (B, M) are given, kernel 5 otherwise. The window is searched on the
    membership predicate itself, whose centre z is centers_xz[..., 1];
    center_z, which the TPU kernel needed for its tile windows, only
    selects the mode, so the crop never depends on it."""
    window = z_window is not None and center_z is not None
    if window and (int(z_window) < 1 or tuple(center_z.shape)
                   != tuple(centers_xz.shape[:2])):
        raise ValueError(f"crop_gather: z_window {z_window} (>= 1 tiles), "
                         f"center_z {tuple(center_z.shape)} for centers "
                         f"{tuple(centers_xz.shape)}")
    if xyz.is_cuda:
        return crop_gather_cuda(xyz, channels, centers_xz, radius, k, grouped,
                                int(z_window) if window else None)
    if window:
        return crop_gather_window_plain(xyz, channels, centers_xz, radius, k,
                                        grouped, int(z_window))
    return crop_gather_plain(xyz, channels, centers_xz, radius, k, grouped)
