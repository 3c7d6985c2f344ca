"""3-NN inverse-squared-distance interpolation (kernel 4:
csrc/interpolate.cu). Port of ws3d_tpu/ops/interpolate.py; the plain
version is _interpolate_xla(force_xla_nn=True)."""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.grouping import pairwise_sqdist


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, n, 3), known (B, m, 3) -> (d2 (B, n, 3), idx (B, n, 3)):
    three masked-min passes, lowest index first on ties, the nearest
    repeated when m < 3."""
    d2 = pairwise_sqdist(unknown, known)                      # (B, n, m)
    m = d2.shape[-1]
    col = torch.arange(m, device=d2.device)
    dists, idxs = [], []
    cur = d2
    for _ in range(min(3, m)):
        best = torch.amin(cur, dim=-1, keepdim=True)
        pick = torch.amin(torch.where(cur == best, col, m), dim=-1,
                          keepdim=True)
        dists.append(torch.gather(d2, -1, pick))
        idxs.append(pick)
        cur = torch.where(col == pick, torch.inf, cur)
    while len(dists) < 3:
        dists.append(dists[0])
        idxs.append(idxs[0])
    return torch.cat(dists, dim=-1), torch.cat(idxs, dim=-1)


def three_interpolate_plain(unknown: torch.Tensor, known: torch.Tensor,
                            known_feats: torch.Tensor,
                            chunk: int = 2048) -> torch.Tensor:
    """Plain version: -> (B, n, C), chunked over the unknown points."""
    outs = []
    for u0 in range(0, unknown.shape[1], chunk):
        d2, idx = three_nn(unknown[:, u0:u0 + chunk], known)
        recip = 1.0 / (d2 + 1e-8)
        weight = recip / torch.sum(recip, dim=-1, keepdim=True)
        B, n, _ = idx.shape
        C = known_feats.shape[-1]
        g = torch.gather(known_feats, 1, idx.reshape(B, n * 3, 1).expand(
            -1, -1, C)).reshape(B, n, 3, C)
        outs.append(torch.sum(g * weight[..., None], dim=2))
    return torch.cat(outs, dim=1)


def three_interpolate_cuda(unknown: torch.Tensor, known: torch.Tensor,
                           known_feats: torch.Tensor) -> torch.Tensor:
    """Kernel 4: (B, n, 3), (B, m, 3), (B, m, C) f32 CUDA -> (B, n, C)."""
    B, n, _ = unknown.shape
    m = known.shape[1]
    C = known_feats.shape[-1]
    _kernels.check_cuda(unknown, "interpolate unknown", torch.float32,
                        (B, n, 3))
    _kernels.check_cuda(known, "interpolate known", torch.float32, (B, m, 3))
    _kernels.check_cuda(known_feats, "interpolate feats", torch.float32,
                        (B, m, C))
    out = torch.empty((B, n, C), dtype=torch.float32, device=unknown.device)
    rc = _kernels.library().ws3d_three_interpolate(
        unknown.data_ptr(), known.data_ptr(), known_feats.data_ptr(), B, n, m,
        C, out.data_ptr(), _kernels.stream_ptr(unknown))
    _kernels.raise_on_error(rc, "three_interpolate")
    _kernels.LAUNCHES["three_interpolate"] += 1
    return out


def interpolate_features(unknown: torch.Tensor, known: torch.Tensor,
                         known_feats: torch.Tensor) -> torch.Tensor:
    """FP interpolation: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if unknown.is_cuda:
        return three_interpolate_cuda(unknown, known, known_feats)
    return three_interpolate_plain(unknown, known, known_feats)
