"""3-NN inverse-squared-distance interpolation (kernel 4:
csrc/interpolate.cu) and the 3-NN search (kernel 7: csrc/three_nn.cu).
Port of ws3d_tpu/ops/interpolate.py; the plain versions are
_interpolate_xla(force_xla_nn=True) and _three_nn_chunk.

interpolate_features is differentiable in the known features: its backward
runs the 3-NN search again (kernel 7 on CUDA) and scatter-adds the weighted
output gradient onto the known rows. The coordinates are data here and get
no gradient."""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.grouping import pairwise_sqdist


def _three_nn_block(unknown: torch.Tensor, known: torch.Tensor):
    """unknown (B, n, 3), known (B, m, 3) -> (d2 (B, n, 3), idx (B, n, 3)
    int64): three masked-min passes, lowest index first on ties, the nearest
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


def three_nn_plain(unknown: torch.Tensor, known: torch.Tensor,
                   chunk: int = 2048):
    """Plain version of kernel 7: -> (d2 (B, n, 3) f32, idx (B, n, 3)
    int32), chunked over the unknown points."""
    parts = [_three_nn_block(unknown[:, u0:u0 + chunk], known)
             for u0 in range(0, unknown.shape[1], chunk)]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1).to(torch.int32))


def three_nn_cuda(unknown: torch.Tensor, known: torch.Tensor):
    """Kernel 7: (B, n, 3), (B, m, 3) f32 CUDA -> (d2 (B, n, 3) f32,
    idx (B, n, 3) int32)."""
    _kernels.check_cuda(unknown, "three_nn unknown", torch.float32,
                        (None, None, 3))
    B, n, _ = unknown.shape
    _kernels.check_cuda(known, "three_nn known", torch.float32, (B, None, 3))
    m = known.shape[1]
    d2 = torch.empty((B, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((B, n, 3), dtype=torch.int32, device=unknown.device)
    rc = _kernels.library().ws3d_three_nn(
        unknown.data_ptr(), known.data_ptr(), B, n, m, d2.data_ptr(),
        idx.data_ptr(), _kernels.stream_ptr(unknown))
    _kernels.raise_on_error(rc, "three_nn")
    _kernels.LAUNCHES["three_nn"] += 1
    return d2, idx


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """(d2 (B, n, 3), idx (B, n, 3) int32) of the three nearest known
    points: kernel 7 on CUDA tensors, the plain version on CPU tensors."""
    if unknown.is_cuda:
        return three_nn_cuda(unknown, known)
    return three_nn_plain(unknown, known)


def three_interpolate_plain(unknown: torch.Tensor, known: torch.Tensor,
                            known_feats: torch.Tensor,
                            chunk: int = 2048) -> torch.Tensor:
    """Plain version: -> (B, n, C), chunked over the unknown points."""
    outs = []
    for u0 in range(0, unknown.shape[1], chunk):
        d2, idx = _three_nn_block(unknown[:, u0:u0 + chunk], known)
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


class _Interpolate(torch.autograd.Function):
    """Forward: kernel 4 on CUDA, its plain version on CPU. Backward (the
    counterpart of interpolate._interpolate_fused_bwd for the features):
    the 3-NN search again (kernel 7 on CUDA), w = (1/(d2+1e-8)) / sum, and
    d known_feats[b, idx[b, i, k]] += w[b, i, k] * g[b, i]."""

    @staticmethod
    def forward(ctx, unknown, known, known_feats):
        ctx.save_for_backward(unknown, known)
        ctx.m = known_feats.shape[1]
        if unknown.is_cuda:
            return three_interpolate_cuda(unknown, known, known_feats)
        return three_interpolate_plain(unknown, known, known_feats)

    @staticmethod
    def backward(ctx, g):
        unknown, known = ctx.saved_tensors
        d2, idx = three_nn(unknown, known)
        recip = 1.0 / (d2 + 1e-8)
        weight = recip / torch.sum(recip, dim=-1, keepdim=True)
        B, n, C = g.shape
        # rows of the (B * m, C) gradient; index_add_ accumulates with
        # atomics on the card, so the order of the sums varies
        rows = (idx.long() + torch.arange(B, device=idx.device)[:, None, None]
                * ctx.m).reshape(B * n, 3)
        grad = torch.zeros((B * ctx.m, C), dtype=g.dtype, device=g.device)
        g2 = g.reshape(B * n, C)
        w2 = weight.reshape(B * n, 3)
        for k in range(3):
            grad.index_add_(0, rows[:, k], g2 * w2[:, k:k + 1])
        return None, None, grad.reshape(B, ctx.m, C)


def interpolate_features(unknown: torch.Tensor, known: torch.Tensor,
                         known_feats: torch.Tensor) -> torch.Tensor:
    """FP interpolation, (B, n, C): the kernels on CUDA tensors, the plain
    versions on CPU tensors. Differentiable in `known_feats` only; raises
    if a coordinate tensor requires a gradient."""
    if unknown.requires_grad or known.requires_grad:
        raise ValueError("interpolate_features: the coordinates get no "
                         "gradient; detach unknown and known")
    return _Interpolate.apply(unknown, known, known_feats)
