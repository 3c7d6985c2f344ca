"""Bytes, operations and the least time of the stage-1 search kernels'
calls, counted from each call's inputs as the port's kernel table counts
rows 6 and 7 (the counts these inputs need, not the work a kernel chose
to do). Each count is taken after the traced stretch, on the same device,
so its own kernels lie outside every span.

Kernel 6, the multi-scale ball query (csrc/ball_query.cu): it reads xyz
and the centres and writes every scale's (B, M, S_i) int32 indices, once
each. Its operations are (8 + scales) a tested point (three differences,
three products, two sums, a compare a scale), where a query must test the
points of its z slab (z term (qz - z)^2 below the largest r^2) that an
index-order scan reaches: up to its S_i-th hit in the scale that fills
last, every point where a scale does not fill.

Kernel 7, the 3-NN search (csrc/three_nn.cu): it reads both clouds and
writes (B, n, 3) distances and indices. Its operations are 10 a tested
pair, where a query must test the known points whose z term is at most
its third-nearest squared distance: no other can be among its three
nearest. The pre-pass of a call without bounds adds the known cloud's z
read once.

The least time is the larger of bytes at the HBM rate and operations at
the float32 SIMT peak. Both counts are lower bounds of what any search
must do, so the share of the roofline never counts work the kernel does
not need.
"""
from __future__ import annotations

import torch

from benchmark.reference import ops
from benchmark.roofline import peaks


def bound_s(note: dict) -> float:
    """note: bytes, ops."""
    return max(note["bytes"] / peaks.HBM_BYTES_S,
               note["ops"] / peaks.F32_FLOP_S)


@torch.no_grad()
def ball_query_counts(radii, nsamples, xyz: torch.Tensor,
                      new_xyz: torch.Tensor, block: int = 256) -> dict:
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    nbytes = 4 * (B * N * 3 + B * M * 3 + B * M * sum(nsamples))
    r2s = [ops.radius_sq(r, xyz.device) for r in radii]
    r2max = max(r2s)
    pos = torch.arange(N, device=xyz.device)
    tested = 0
    for m0 in range(0, M, block):
        q = new_xyz[:, m0:m0 + block]
        d2 = ops.sqdist(q, xyz)
        reach = None
        for r2, s in zip(r2s, nsamples):
            cum = torch.cumsum((d2 < r2).to(torch.int32), dim=-1)
            at = torch.searchsorted(cum, torch.full_like(
                cum[..., :1], int(s)))[..., 0] + 1
            at = torch.where(cum[..., -1] >= s, at, N)
            reach = at if reach is None else torch.maximum(reach, at)
        dz = q[..., 2, None] - xyz[:, None, :, 2]
        tested += int(((dz * dz < r2max) & (pos < reach[..., None])).sum())
    return {"bytes": nbytes, "ops": (8 + len(radii)) * tested}


@torch.no_grad()
def three_nn_counts(unknown: torch.Tensor, known: torch.Tensor,
                    prepass: bool, block: int = 2048) -> dict:
    B, n, _ = unknown.shape
    m = known.shape[1]
    nbytes = 4 * (B * n * 3 + B * m * 3 + B * n * 6) + \
        (4 * B * m if prepass else 0)
    pairs = 0
    for u0 in range(0, n, block):
        u = unknown[:, u0:u0 + block]
        d2, _ = ops.three_nn(u, known)
        dz = u[..., 2, None] - known[:, None, :, 2]
        pairs += int((dz * dz <= d2[..., 2:3]).sum())
    return {"bytes": nbytes, "ops": 10 * pairs}
