"""Multi-scale ball query (kernels 6 and 6w: csrc/ball_query.cu).

Port of ws3d_tpu/ops/ball_query_pallas.py. Kernel 6 is its pad-with-first
mode, as ws3d_tpu/ops/grouping.py:ball_query_multi reaches it: for each
query and radius scale the first ``nsample`` points with d2 < r2 (strict) in
ascending index order, padded with the first hit, index 0 everywhere when the
ball is empty. Kernel 6w is its ``wrap_pad`` mode: slot s takes the
(s % cnt)-th in-ball point and the true in-ball counts come back too (an
empty ball gives 0 and count 0). r2 is the f32 rounding of the double
product radius*radius; d2 is the term-rounded 3-D (dx^2 + dy^2) + dz^2.
The plain versions are the chunked query sharing one distance block over the
scales (grouping._ball_query_chunk_multi) and roipool's first-k wraparound.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.grouping import (pairwise_sqdist, radius_sq,
                                         select_in_ball)
from ws3d_tpu_torch.ops.roipool import first_k_wraparound

MAX_SCALES = 4          # csrc/common.cuh:kMaxScales


def ball_query_multi_plain(radii: Sequence[float], nsamples: Sequence[int],
                           xyz: torch.Tensor, new_xyz: torch.Tensor,
                           chunk: int = 512) -> Tuple[torch.Tensor, ...]:
    """Plain version: xyz (B, N, 3), new_xyz (B, M, 3) -> per scale
    (B, M, nsample) int32, one (B, chunk, N) distance block per query chunk
    shared by every scale."""
    r2s = [radius_sq(r, xyz.device) for r in radii]
    outs = [[] for _ in radii]
    for m0 in range(0, new_xyz.shape[1], chunk):
        d2 = pairwise_sqdist(new_xyz[:, m0:m0 + chunk], xyz)
        for out, r2, s in zip(outs, r2s, nsamples):
            out.append(select_in_ball(d2, r2, int(s)).to(torch.int32))
    return tuple(torch.cat(o, dim=1) for o in outs)


def _scale_args(radii, nsamples, name):
    """Check the scales and pack r2 and the sample counts as C arrays."""
    if not 1 <= len(radii) == len(nsamples) <= MAX_SCALES:
        raise ValueError(f"{name}: {len(radii)} radii and "
                         f"{len(nsamples)} sample counts (1..{MAX_SCALES})")
    if any(int(s) <= 0 for s in nsamples):
        raise ValueError(f"{name}: sample counts {list(nsamples)}")
    n = len(radii)
    # f32 rounding of the double product, as radius_sq
    r2 = (ctypes.c_float * n)(*[float(r) * float(r) for r in radii])
    return r2, (ctypes.c_int * n)(*[int(s) for s in nsamples])


def ball_query_multi_cuda(radii: Sequence[float], nsamples: Sequence[int],
                          xyz: torch.Tensor,
                          new_xyz: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Kernel 6: (B, N, 3), (B, M, 3) f32 CUDA -> per scale (B, M, S_i)
    int32, all scales in one launch (after a pre-pass that writes the
    cloud's chunk z ranges into a workspace)."""
    r2, ns = _scale_args(radii, nsamples, "ball_query")
    _kernels.check_cuda(xyz, "ball_query xyz", torch.float32, (None, None, 3))
    B, N, _ = xyz.shape
    _kernels.check_cuda(new_xyz, "ball_query new_xyz", torch.float32,
                        (B, None, 3))
    M = new_xyz.shape[1]
    outs = tuple(torch.empty((B, M, int(s)), dtype=torch.int32,
                             device=xyz.device) for s in nsamples)
    ptrs = (ctypes.c_void_p * len(outs))(*[o.data_ptr() for o in outs])
    bounds = _kernels.chunk_bounds_workspace(xyz)
    rc = _kernels.library().ws3d_ball_query(
        xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, len(outs), r2, ns, ptrs,
        bounds.data_ptr(), _kernels.stream_ptr(xyz))
    _kernels.raise_on_error(rc, "ball_query")
    _kernels.LAUNCHES["ball_query"] += 1
    return outs


def ball_query_wrap_plain(radii: Sequence[float], nsamples: Sequence[int],
                          xyz: torch.Tensor, new_xyz: torch.Tensor,
                          chunk: int = 512):
    """Plain version of kernel 6w: -> (per scale idx (B, M, S_i) int32, per
    scale counts (B, M) int32), one (B, chunk, N) distance block per query
    chunk shared by every scale."""
    r2s = [radius_sq(r, xyz.device) for r in radii]
    idx = [[] for _ in radii]
    cnt = [[] for _ in radii]
    for m0 in range(0, new_xyz.shape[1], chunk):
        d2 = pairwise_sqdist(new_xyz[:, m0:m0 + chunk], xyz)
        for i, (r2, s) in enumerate(zip(r2s, nsamples)):
            member = d2 < r2
            idx[i].append(first_k_wraparound(member, int(s))[0]
                          .to(torch.int32))
            cnt[i].append(member.sum(-1).to(torch.int32))
    return (tuple(torch.cat(i, dim=1) for i in idx),
            tuple(torch.cat(c, dim=1) for c in cnt))


def ball_query_wrap_cuda(radii: Sequence[float], nsamples: Sequence[int],
                         xyz: torch.Tensor, new_xyz: torch.Tensor):
    """Kernel 6w: (B, N, 3), (B, M, 3) f32 CUDA -> (per scale idx
    (B, M, S_i) int32, per scale counts (B, M) int32), all scales in one
    launch (after a pre-pass that writes the cloud's chunk z ranges into a
    workspace)."""
    r2, ns = _scale_args(radii, nsamples, "ball_query_wrap")
    _kernels.check_cuda(xyz, "ball_query_wrap xyz", torch.float32,
                        (None, None, 3))
    B, N, _ = xyz.shape
    _kernels.check_cuda(new_xyz, "ball_query_wrap new_xyz", torch.float32,
                        (B, None, 3))
    M = new_xyz.shape[1]
    idx = tuple(torch.empty((B, M, int(s)), dtype=torch.int32,
                            device=xyz.device) for s in nsamples)
    cnt = tuple(torch.empty((B, M), dtype=torch.int32, device=xyz.device)
                for _ in nsamples)
    n = len(idx)
    bounds = _kernels.chunk_bounds_workspace(xyz)
    rc = _kernels.library().ws3d_ball_query_wrap(
        xyz.data_ptr(), new_xyz.data_ptr(), B, N, M, n, r2, ns,
        (ctypes.c_void_p * n)(*[o.data_ptr() for o in idx]),
        (ctypes.c_void_p * n)(*[o.data_ptr() for o in cnt]),
        bounds.data_ptr(), _kernels.stream_ptr(xyz))
    _kernels.raise_on_error(rc, "ball_query_wrap")
    _kernels.LAUNCHES["ball_query_wrap"] += 1
    return idx, cnt


def ball_query_wrap(radii: Sequence[float], nsamples: Sequence[int],
                    xyz: torch.Tensor, new_xyz: torch.Tensor):
    """Counterpart of ball_query_pallas(..., wrap_pad=True): (idx tuple,
    counts tuple). Kernel 6w on CUDA tensors, its plain version on CPU
    tensors."""
    if xyz.is_cuda:
        return ball_query_wrap_cuda(radii, nsamples, xyz, new_xyz)
    return ball_query_wrap_plain(radii, nsamples, xyz, new_xyz)
