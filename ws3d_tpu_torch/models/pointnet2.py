"""PointNet++ set abstraction / feature propagation, channel-last, eval
(port of ws3d_tpu/models/pointnet2.py).

Every SA scale with a sampled centre set goes through the fused SA kernel
(the windowed entry for z-sorted inputs where the JAX package dispatches
its windowed kernel, the full entry elsewhere); GroupAll is plain tensor
code. FP stages use the eval layer-0 fold around the 3-NN interpolation
kernel.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ws3d_tpu_torch.models.layers import SharedMLP
from ws3d_tpu_torch.ops.fused_sa import fused_sa
from ws3d_tpu_torch.ops.grouping import group_all
from ws3d_tpu_torch.ops.interpolate import interpolate_features
from ws3d_tpu_torch.ops.sampling import furthest_point_sample_with_coords


def use_window(sorted_points: bool, n_points: int, n_feat: int) -> bool:
    """The JAX package's dispatch (pointnet2.py:_use_window): the windowed
    kernel for z-sorted clouds with a tiny channel width at large P, or at
    crop scale (256 <= P <= 1024); the full kernel otherwise."""
    if not sorted_points:
        return False
    return (n_feat + 3 < 32 and n_points > 1024) or 256 <= n_points <= 1024


class PointnetSAModuleMSG(nn.Module):
    """Multi-scale-grouping SA; npoint None means GroupAll."""

    def __init__(self, npoint: Optional[int], radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]],
                 cin: int, use_bn: bool = True, sorted_points: bool = False):
        super().__init__()
        self.npoint = npoint
        self.radii = [float(r) for r in radii]
        self.nsamples = [int(s) for s in nsamples]
        self.sorted_points = sorted_points
        for i, m in enumerate(mlps):
            self.add_module(f"mlp_{i}", SharedMLP(cin + 3, m, use_bn=use_bn))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor):
        """xyz (B, N, 3), features (B, N, C) -> (new_xyz (B, npoint, 3) or
        None, new_features (B, npoint or 1, sum C_out))."""
        new_xyz = None
        if self.npoint is not None:
            idx, new_xyz = furthest_point_sample_with_coords(xyz, self.npoint)
            if self.sorted_points:
                # restore ascending index (= z) order, stable like lax.sort
                order = torch.sort(idx, dim=1, stable=True).indices
                new_xyz = torch.gather(new_xyz, 1,
                                       order[..., None].expand(-1, -1, 3))
            new_xyz = new_xyz.contiguous()
        window = use_window(self.sorted_points, xyz.shape[1],
                            features.shape[-1])
        outs = []
        for i in range(len(self.radii)):
            mlp = getattr(self, f"mlp_{i}")
            if self.npoint is None:
                h = mlp(group_all(xyz, features))
                outs.append(torch.amax(h, dim=2))
                continue
            kernels, biases = mlp.folded()
            outs.append(fused_sa(
                xyz, features, new_xyz, self.radii[i], self.nsamples[i],
                kernels, biases, window,
                params=mlp.packed() if xyz.is_cuda else None))
        return new_xyz, torch.cat(outs, dim=-1)


class PointnetFPModule(nn.Module):
    """Feature propagation with the eval layer-0 fold: interpolation is
    linear in the features, so interp(F) @ W0a == interp(F @ W0a); the skip
    rows W0b apply to the unknown features outside."""

    def __init__(self, c_known: int, c_unknown: int, mlp: Sequence[int],
                 use_bn: bool = True):
        super().__init__()
        self.c_known = c_known
        self.SharedMLP_0 = SharedMLP(c_known + c_unknown, mlp, use_bn=use_bn)

    def forward(self, unknown: torch.Tensor, known: torch.Tensor,
                unknown_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor) -> torch.Tensor:
        kernels, biases = self.SharedMLP_0.folded()
        ci = self.c_known
        feats_f = torch.matmul(known_feats, kernels[0][:ci]).contiguous()
        h = interpolate_features(unknown, known, feats_f)
        if unknown_feats is not None:
            h = h + torch.matmul(unknown_feats, kernels[0][ci:])
        h = torch.relu(h + biases[0])
        for W, b in zip(kernels[1:], biases[1:]):
            h = torch.relu(torch.matmul(h, W) + b)
        return h
