"""Plain tensor versions of the point operations the detector is built
from, written for any device and computed in blocks so that they fit on
the card at the cells' sizes. Their semantics are the port's (and the JAX
package's) as its plain versions state them:

- furthest point sampling seeds with index 0, keeps a min-d2 cache that
  starts at 1e10, and takes the argmax with the lowest index on ties;
- a ball query returns, for each query, the first `nsample` points with
  d2 < r2 (strict, the direct dx^2 + dy^2 + dz^2 form, r2 rounded once to
  float32) in ascending index order, padded with the first hit, and 0
  everywhere for an empty ball;
- the 3-NN interpolation weights the three nearest known points (lowest
  index first on ties) by 1 / (d2 + 1e-8), normalised;
- the BEV crop takes the first 512 members within 4 m in index order and
  maps slots to members by the grouped-duplicates rule;
- the greedy sweep keeps row i iff it is valid and no kept row j < i has
  pair[j, i] > thresh.
"""
from __future__ import annotations

import torch


def radius_sq(radius: float, device) -> torch.Tensor:
    return torch.tensor(float(radius) * float(radius), dtype=torch.float32,
                        device=device)


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., M, 3), b (..., N, 3) -> (..., M, N)."""
    d = None
    for c in range(3):
        dc = a[..., :, None, c] - b[..., None, :, c]
        d = dc * dc if d is None else d + dc * dc
    return d


def fps(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """xyz (R, N, 3) -> (R, npoint) int64 picks."""
    R, N, _ = xyz.shape
    idx = torch.zeros((R, npoint), dtype=torch.int64, device=xyz.device)
    min_d2 = torch.full((R, N), 1e10, dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(R, device=xyz.device)
    last = torch.zeros(R, dtype=torch.int64, device=xyz.device)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    for i in range(1, npoint):
        lp = xyz[rows, last]
        dx, dy, dz = x - lp[:, 0:1], y - lp[:, 1:2], z - lp[:, 2:3]
        d2 = dx * dx + dy * dy + dz * dz
        min_d2 = torch.minimum(min_d2, d2)
        last = torch.argmax(min_d2, dim=-1)
        idx[:, i] = last
    return idx


def take(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (B, N, C), idx (B, ...) -> (B, ..., C)."""
    B = points.shape[0]
    flat = idx.reshape(B, -1)
    out = torch.gather(points, 1, flat[..., None].expand(
        -1, -1, points.shape[-1]))
    return out.reshape(idx.shape + (points.shape[-1],))


def first_k(mask: torch.Tensor, k: int) -> torch.Tensor:
    """(..., N) bool -> (..., k) positions of the first k True entries;
    N past the count."""
    rank = torch.cumsum(mask.to(torch.int32), dim=-1)
    want = torch.arange(1, k + 1, device=mask.device, dtype=rank.dtype)
    return torch.searchsorted(rank, want.expand(mask.shape[:-1] + (k,))
                              .contiguous(), side="left")


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """xyz (B, N, 3), new_xyz (B, M, 3) -> (B, M, nsample) int64."""
    r2 = radius_sq(radius, xyz.device)
    N = xyz.shape[1]
    out = []
    for m0 in range(0, new_xyz.shape[1], chunk):
        d2 = sqdist(new_xyz[:, m0:m0 + chunk], xyz)
        idx = first_k(d2 < r2, nsample)
        first = idx[..., 0:1]
        idx = torch.where(idx < N, idx, first)
        out.append(torch.where(first < N, idx, torch.zeros_like(idx)))
    return torch.cat(out, dim=1)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """-> (d2 (B, n, 3), idx (B, n, 3)) of the three nearest known points,
    lowest index first on ties."""
    d2 = sqdist(unknown, known)
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


def interpolate(unknown: torch.Tensor, known: torch.Tensor,
                known_feats: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """(B, n, C) features at `unknown` from the three nearest known points."""
    out = []
    for u0 in range(0, unknown.shape[1], chunk):
        d2, idx = three_nn(unknown[:, u0:u0 + chunk], known)
        recip = 1.0 / (d2 + 1e-8)
        w = recip / torch.sum(recip, dim=-1, keepdim=True)
        out.append(torch.sum(take(known_feats, idx) * w[..., None], dim=2))
    return torch.cat(out, dim=1)


def slot_members(cnt: torch.Tensor, k: int) -> torch.Tensor:
    """cnt (...,) -> (..., k) member rank of each slot, grouped duplicates:
    the first k % cnt members take k // cnt + 1 slots, the rest k // cnt."""
    s = torch.arange(k, device=cnt.device)
    c = torch.clamp(cnt.long(), min=1)[..., None]
    q, r = k // c, k % c
    thresh = r * (q + 1)
    j = torch.where(s < thresh, s // (q + 1),
                    r + (s - thresh) // torch.clamp(q, min=1))
    return torch.where(c >= k, s, j)


def bev_crop(xyz: torch.Tensor, channels: torch.Tensor,
             centers_xz: torch.Tensor, radius: float, k: int):
    """xyz (B, N, 3), channels (B, N, C), centers (B, M, 2) -> (vals
    (B, M, k, C), cnt (B, M)): the first k members within `radius` in BEV,
    grouped-duplicate slots, zeros for an empty crop."""
    r2 = radius_sq(radius, xyz.device)
    dx = centers_xz[..., 0:1] - xyz[:, None, :, 0]
    dz = centers_xz[..., 1:2] - xyz[:, None, :, 2]
    member = dx * dx + dz * dz < r2
    N = xyz.shape[1]
    cnt = member.sum(-1)
    kk = min(k, N)
    first = first_k(member, kk)
    j = torch.clamp(slot_members(cnt, k), max=kk - 1)
    idx = torch.gather(first, -1, j).clamp(max=N - 1)
    vals = take(channels, idx)
    vals = torch.where((cnt == 0)[..., None, None], 0.0, vals)
    return vals, cnt


def greedy_suppress(pair: torch.Tensor, thresh: float,
                    valid: torch.Tensor) -> torch.Tensor:
    """pair (..., K, K), valid (..., K) -> keep (..., K), rows in score
    order."""
    K = pair.shape[-1]
    suppress = pair > thresh
    keep = torch.zeros_like(valid)
    for i in range(K):
        killed = torch.any(keep[..., :i] & suppress[..., :i, i], dim=-1)
        keep[..., i] = valid[..., i] & ~killed
    return keep


def top_k(x: torch.Tensor, k: int):
    """Descending along the last axis, the lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
