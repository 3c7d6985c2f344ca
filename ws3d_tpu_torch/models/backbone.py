"""Pointnet2MSG backbone: 4 MSG SA stages + 4 FP stages back to all points
(port of ws3d_tpu/models/backbone.py)."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ws3d_tpu_torch.models.pointnet2 import (PointnetFPModule,
                                             PointnetSAModuleMSG)


class Pointnet2MSG(nn.Module):
    def __init__(self, cin: int, sa_npoints: Sequence[int], sa_radius,
                 sa_nsample, sa_mlps, fp_mlps, use_bn: bool = True,
                 sorted_points: bool = False, dtype=None):
        super().__init__()
        self.n_sa = len(sa_npoints)
        self.n_fp = len(fp_mlps)
        skip = [cin]
        c = cin
        for k in range(self.n_sa):
            sa = PointnetSAModuleMSG(
                npoint=int(sa_npoints[k]), radii=sa_radius[k],
                nsamples=sa_nsample[k], mlps=sa_mlps[k], cin=c,
                use_bn=use_bn, sorted_points=sorted_points, dtype=dtype)
            self.add_module(f"sa_{k}", sa)
            c = sa.out_channels
            skip.append(c)
        # sorted_points is not forwarded to the FP stages, as the JAX
        # package does not forward it (its windowed 3-NN measured slower on
        # the TPU); PointnetFPModule(sorted_points=True) stays an entry point
        for i in range(self.n_fp - 1, -1, -1):
            c_known = skip[i + 1] if i == self.n_fp - 1 else int(
                fp_mlps[i + 1][-1])
            self.add_module(f"fp_{i}", PointnetFPModule(
                c_known, skip[i], fp_mlps[i], use_bn=use_bn, dtype=dtype))

    def forward(self, pts: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.1):
        """pts (B, N, 3+C) -> (xyz (B, N, 3), features (B, N, fp_mlps[0][-1]))."""
        xyz = pts[..., 0:3].contiguous()
        features = pts[..., 3:].contiguous() if pts.shape[-1] > 3 else None
        l_xyz, l_feats = [xyz], [features]
        for k in range(self.n_sa):
            new_xyz, new_feats = getattr(self, f"sa_{k}")(
                l_xyz[k], l_feats[k], train, bn_momentum)
            l_xyz.append(new_xyz)
            l_feats.append(new_feats)
        for i in range(self.n_fp - 1, -1, -1):
            l_feats[i] = getattr(self, f"fp_{i}")(
                l_xyz[i], l_xyz[i + 1], l_feats[i], l_feats[i + 1], train,
                bn_momentum)
        return l_xyz[0], l_feats[0]
