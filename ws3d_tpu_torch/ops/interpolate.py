"""3-NN inverse-squared-distance interpolation (kernel 4:
csrc/interpolate.cu), its windowed form for z-sorted clouds (kernel 8, the
same file) and the 3-NN search (kernel 7: csrc/three_nn.cu). Port of
ws3d_tpu/ops/interpolate.py; the plain versions are
_interpolate_xla(force_xla_nn=True), _three_nn_chunk and, for kernel 8, the
window search written out step by step.

interpolate_features is differentiable in the known features: its backward
runs the 3-NN search again (kernel 7 on CUDA, with either forward: kernel 8
picks exactly kernel 7's neighbours) and scatter-adds the weighted output
gradient onto the known rows. The coordinates are data here and get no
gradient.

bf16_out (cfg.TPU.COMPUTE_DTYPE=bfloat16) returns bf16, as the TPU kernel
stores into its out_dtype (three_nn_pallas.py:96-101): the weights and sums
stay f32 and only the result is rounded (to nearest even); kernel 4 rounds
as it stores. The TPU kernel also rounds the weights and features to bf16
for its matmul; the JAX package's CPU path (_interpolate_xla) does not, and
neither does the port. Kernel 8 and the plain windowed version compute f32
and cast after, as ws3d_tpu/ops/interpolate.py does for the windowed
kernel. The bf16 output's backward casts the cotangent to f32 and runs the
f32 backward (interpolate._interpolate_fused_bwd); the gradient keeps the
known features' dtype."""
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


def _workspace(known: torch.Tensor, bounds, name: str) -> torch.Tensor:
    """`bounds` checked as the chunk-bounds workspace of `known`
    (_kernels.chunk_bounds_workspace's shape), or a fresh one if None."""
    if bounds is None:
        return _kernels.chunk_bounds_workspace(known)
    B, m, _ = known.shape
    _kernels.check_cuda(bounds, name, torch.float32,
                        (B, (m + _kernels.CHUNK - 1) // _kernels.CHUNK, 2))
    return bounds


def three_nn_cuda(unknown: torch.Tensor, known: torch.Tensor,
                  bounds: torch.Tensor | None = None):
    """Kernel 7: (B, n, 3), (B, m, 3) f32 CUDA -> (d2 (B, n, 3) f32,
    idx (B, n, 3) int32). `bounds`, if given, holds the chunk z ranges a
    pre-pass wrote for this very `known` (kernel 4's forward on it); else a
    pre-pass writes them into a fresh workspace."""
    _kernels.check_cuda(unknown, "three_nn unknown", torch.float32,
                        (None, None, 3))
    B, n, _ = unknown.shape
    _kernels.check_cuda(known, "three_nn known", torch.float32, (B, None, 3))
    m = known.shape[1]
    fill = bounds is None
    bounds = _workspace(known, bounds, "three_nn bounds")
    d2 = torch.empty((B, n, 3), dtype=torch.float32, device=unknown.device)
    idx = torch.empty((B, n, 3), dtype=torch.int32, device=unknown.device)
    rc = _kernels.library().ws3d_three_nn(
        unknown.data_ptr(), known.data_ptr(), B, n, m, d2.data_ptr(),
        idx.data_ptr(), bounds.data_ptr(), int(fill),
        _kernels.stream_ptr(unknown))
    _kernels.raise_on_error(rc, "three_nn")
    _kernels.LAUNCHES["three_nn"] += 1
    return d2, idx


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             bounds: torch.Tensor | None = None):
    """(d2 (B, n, 3), idx (B, n, 3) int32) of the three nearest known
    points: kernel 7 on CUDA tensors (with `bounds` as three_nn_cuda takes
    them), the plain version on CPU tensors."""
    if unknown.is_cuda:
        return three_nn_cuda(unknown, known, bounds)
    return three_nn_plain(unknown, known)


def _weighted_rows(known_feats: torch.Tensor, d2: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """(B, n, C): the three rows of each query weighted 1/(d2+1e-8),
    normalised."""
    recip = 1.0 / (d2 + 1e-8)
    weight = recip / torch.sum(recip, dim=-1, keepdim=True)
    B, n, _ = idx.shape
    C = known_feats.shape[-1]
    g = torch.gather(known_feats, 1, idx.long().reshape(B, n * 3, 1).expand(
        -1, -1, C)).reshape(B, n, 3, C)
    return torch.sum(g * weight[..., None], dim=2)


def three_interpolate_plain(unknown: torch.Tensor, known: torch.Tensor,
                            known_feats: torch.Tensor, chunk: int = 2048,
                            bf16_out: bool = False) -> torch.Tensor:
    """Plain version: -> (B, n, C) f32, chunked over the unknown points;
    with `bf16_out` the f32 result rounded to bf16."""
    out = torch.cat([_weighted_rows(known_feats, *_three_nn_block(
        unknown[:, u0:u0 + chunk], known))
        for u0 in range(0, unknown.shape[1], chunk)], dim=1)
    return out.to(torch.bfloat16) if bf16_out else out


def _before(a, ia, b, ib):
    """(d2, index) order: a before b."""
    return (a < b) | ((a == b) & (ia < ib))


def window_search(unknown: torch.Tensor, known: torch.Tensor):
    """The windowed search of kernel 8's plain version for clouds sorted
    ascending by z, written out for all queries at once: -> (d2 (B, n, 3)
    f32, idx (B, n, 3) int64, visits (B, n) int64, the candidates each
    query tested).

    From each query's home (the first known z >= its own, a binary search)
    the search steps outward, always to the side whose next point has the
    smaller z term fl(dz)^2, and inserts each candidate into a running top-3
    ordered by (d2, index). A side stops once its next term is greater than
    the current third-best d2 (strictly: an equal d2 can still win a tie
    towards a lower index). The term-rounded d2 is at least the z term, and
    the term only grows along a side, so the result is the full search's."""
    B, n, _ = unknown.shape
    m = known.shape[1]
    kz = known[..., 2].contiguous()
    qx, qy, qz = unknown[..., 0], unknown[..., 1], unknown[..., 2]
    home = torch.searchsorted(kz, qz.contiguous(), side="left")
    left, right = home - 1, home.clone()
    d = torch.full((B, n, 3), torch.inf, dtype=unknown.dtype,
                   device=unknown.device)
    nn = torch.full((B, n, 3), -1, dtype=torch.long, device=unknown.device)
    visits = torch.zeros((B, n), dtype=torch.long, device=unknown.device)

    def term(j):
        dz = qz - torch.gather(kz, 1, j.clamp(0, m - 1))
        return dz * dz

    while True:
        go_l = (left >= 0) & ~(term(left) > d[..., 2])
        go_r = (right < m) & ~(term(right) > d[..., 2])
        live = go_l | go_r
        if not bool(live.any()):
            break
        take_l = go_l & (~go_r | (term(left) <= term(right)))
        j = torch.where(take_l, left, right)
        jc = j.clamp(0, m - 1)
        p = torch.gather(known, 1, jc[..., None].expand(-1, -1, 3))
        dx, dy, dz = qx - p[..., 0], qy - p[..., 1], qz - p[..., 2]
        v = torch.where(live, dx * dx + dy * dy + dz * dz, torch.inf)
        j = torch.where(live, j, m)
        b2 = _before(v, j, d[..., 2], nn[..., 2])
        b1 = _before(v, j, d[..., 1], nn[..., 1])
        b0 = _before(v, j, d[..., 0], nn[..., 0])
        d = torch.stack([torch.where(b0, v, d[..., 0]),
                         torch.where(b0, d[..., 0],
                                     torch.where(b1, v, d[..., 1])),
                         torch.where(b1, d[..., 1],
                                     torch.where(b2, v, d[..., 2]))], -1)
        nn = torch.stack([torch.where(b0, j, nn[..., 0]),
                          torch.where(b0, nn[..., 0],
                                      torch.where(b1, j, nn[..., 1])),
                          torch.where(b1, nn[..., 1],
                                      torch.where(b2, j, nn[..., 2]))], -1)
        visits += live.long()
        left = torch.where(live & take_l, left - 1, left)
        right = torch.where(live & ~take_l, right + 1, right)
    for s in (1, 2):                  # m < 3: repeat the nearest
        empty = nn[..., s] < 0
        d[..., s] = torch.where(empty, d[..., 0], d[..., s])
        nn[..., s] = torch.where(empty, nn[..., 0], nn[..., s])
    return d, nn, visits


def three_nn_window_plain(unknown: torch.Tensor, known: torch.Tensor):
    """Kernel 8's neighbours: (d2 (B, n, 3) f32, idx (B, n, 3) int32), for
    clouds sorted ascending by z; equal to three_nn_plain there."""
    d2, idx, _ = window_search(unknown, known)
    return d2, idx.to(torch.int32)


def three_interpolate_window_plain(unknown: torch.Tensor, known: torch.Tensor,
                                   known_feats: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel 8: -> (B, n, C), clouds sorted ascending
    by z."""
    return _weighted_rows(known_feats, *window_search(unknown, known)[:2])


def three_interpolate_cuda(unknown: torch.Tensor, known: torch.Tensor,
                           known_feats: torch.Tensor,
                           bounds: torch.Tensor | None = None,
                           bf16_out: bool = False) -> torch.Tensor:
    """Kernel 4: (B, n, 3), (B, m, 3), (B, m, C) f32 CUDA -> (B, n, C), f32
    or with `bf16_out` bf16 (after a pre-pass that writes the known cloud's
    chunk z ranges into a workspace: `bounds`, from
    _kernels.chunk_bounds_workspace(known), or a fresh one)."""
    B, n, _ = unknown.shape
    m = known.shape[1]
    C = known_feats.shape[-1]
    _kernels.check_cuda(unknown, "interpolate unknown", torch.float32,
                        (B, n, 3))
    _kernels.check_cuda(known, "interpolate known", torch.float32, (B, m, 3))
    _kernels.check_cuda(known_feats, "interpolate feats", torch.float32,
                        (B, m, C))
    out = torch.empty((B, n, C), device=unknown.device,
                      dtype=torch.bfloat16 if bf16_out else torch.float32)
    bounds = _workspace(known, bounds, "interpolate bounds")
    rc = _kernels.library().ws3d_three_interpolate(
        unknown.data_ptr(), known.data_ptr(), known_feats.data_ptr(), B, n, m,
        C, out.data_ptr(), bounds.data_ptr(), int(bool(bf16_out)),
        _kernels.stream_ptr(unknown))
    name = "three_interpolate_bf16" if bf16_out else "three_interpolate"
    _kernels.raise_on_error(rc, name)
    _kernels.LAUNCHES[name] += 1
    return out


def three_interpolate_window_cuda(unknown: torch.Tensor, known: torch.Tensor,
                                  known_feats: torch.Tensor,
                                  with_nn: bool = False):
    """Kernel 8: (B, n, 3), (B, m, 3) sorted ascending by z, (B, m, C) f32
    CUDA -> (B, n, C); with `with_nn` also its neighbours (d2 (B, n, 3) f32,
    idx (B, n, 3) int32).

    Kernel 4's staged search with each known chunk's first and last z as its
    z range, read in place (no pre-pass, no workspace): on a known cloud
    sorted by z the result is window_search's and kernel 4's, bit for bit.
    On a known cloud that is not sorted those ends bound nothing, and kernel
    8 returns three known points with their d2 and weights that are not
    always the nearest (its plain version, window_search, is defined for
    sorted clouds only)."""
    B, n, _ = unknown.shape
    m = known.shape[1]
    C = known_feats.shape[-1]
    _kernels.check_cuda(unknown, "interpolate unknown", torch.float32,
                        (B, n, 3))
    _kernels.check_cuda(known, "interpolate known", torch.float32, (B, m, 3))
    _kernels.check_cuda(known_feats, "interpolate feats", torch.float32,
                        (B, m, C))
    out = torch.empty((B, n, C), dtype=torch.float32, device=unknown.device)
    d2 = idx = None
    if with_nn:
        d2 = torch.empty((B, n, 3), dtype=torch.float32, device=unknown.device)
        idx = torch.empty((B, n, 3), dtype=torch.int32, device=unknown.device)
    rc = _kernels.library().ws3d_three_interpolate_window(
        unknown.data_ptr(), known.data_ptr(), known_feats.data_ptr(), B, n, m,
        C, out.data_ptr(), None if idx is None else idx.data_ptr(),
        None if d2 is None else d2.data_ptr(), _kernels.stream_ptr(unknown))
    _kernels.raise_on_error(rc, "three_interpolate_window")
    _kernels.LAUNCHES["three_interpolate_window"] += 1
    return (out, d2, idx) if with_nn else out


class _Interpolate(torch.autograd.Function):
    """Forward: kernel 4 (kernel 8 with sorted_z) on CUDA, its plain version
    on CPU. Backward (the counterpart of interpolate._interpolate_fused_bwd
    for the features): the 3-NN search again (kernel 7 on CUDA, on the
    chunk z ranges kernel 4's pre-pass wrote for the same known cloud),
    w = (1/(d2+1e-8)) / sum, and
    d known_feats[b, idx[b, i, k]] += w[b, i, k] * g[b, i]. A bf16 output's
    cotangent is cast to f32 first, as the JAX backward casts it."""

    @staticmethod
    def forward(ctx, unknown, known, known_feats, sorted_z, bf16_out):
        ctx.m = known_feats.shape[1]
        ctx.bounds = None
        ctx.feats_dtype = known_feats.dtype
        ctx.save_for_backward(unknown, known)
        if sorted_z:
            if unknown.is_cuda:
                out = three_interpolate_window_cuda(unknown, known,
                                                    known_feats)
            else:
                out = three_interpolate_window_plain(unknown, known,
                                                     known_feats)
            return out.to(torch.bfloat16) if bf16_out else out
        if unknown.is_cuda:
            ctx.bounds = _kernels.chunk_bounds_workspace(known)
            return three_interpolate_cuda(unknown, known, known_feats,
                                          ctx.bounds, bf16_out=bf16_out)
        return three_interpolate_plain(unknown, known, known_feats,
                                       bf16_out=bf16_out)

    @staticmethod
    def backward(ctx, g):
        g = g.float()
        unknown, known = ctx.saved_tensors
        d2, idx = three_nn(unknown, known, ctx.bounds)
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
        return (None, None, grad.reshape(B, ctx.m, C).to(ctx.feats_dtype),
                None, None)


def interpolate_features(unknown: torch.Tensor, known: torch.Tensor,
                         known_feats: torch.Tensor, sorted_z: bool = False,
                         bf16_out: bool = False) -> torch.Tensor:
    """FP interpolation, (B, n, C): the kernels on CUDA tensors, the plain
    versions on CPU tensors. With `sorted_z` (both clouds sorted ascending
    by z, as cfg.TPU.SORT_POINTS_Z and the SA modules' sorted picks leave
    them) the forward is the windowed search, kernel 8 on CUDA; the result
    is the same. `bf16_out` returns bf16 (see the module docstring).
    Differentiable in `known_feats` only; raises if a coordinate tensor
    requires a gradient."""
    if unknown.requires_grad or known.requires_grad:
        raise ValueError("interpolate_features: the coordinates get no "
                         "gradient; detach unknown and known")
    return _Interpolate.apply(unknown, known, known_feats, bool(sorted_z),
                              bool(bf16_out))
