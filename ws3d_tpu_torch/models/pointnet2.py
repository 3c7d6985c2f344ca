"""PointNet++ set abstraction / feature propagation, channel-last (port of
ws3d_tpu/models/pointnet2.py).

Eval: every SA scale with a sampled centre set goes through the fused SA
kernel (the windowed entry for z-sorted inputs where the JAX package
dispatches its windowed kernel, the full entry elsewhere) with BatchNorm
folded into the weights; FP stages use the layer-0 fold around the 3-NN
interpolation kernel. Train (train=True): a BatchNorm stage needs the
batch statistics, so, as the JAX package declines its fused kernels there,
it runs the multi-scale ball query kernel, a differentiable gather, the MLP
and a max over the samples, and FP interpolates, concatenates the skip
features and runs the MLP unfolded. A BN-free SA stage (the stage-2 stacks)
keeps the fused kernel of eval on its live weights and differentiates it
with ops.fused_sa.FusedSA, as the JAX package does on the chip. GroupAll is
plain tensor code in both.
Without per-point features (RPN.USE_INTENSITY=False) the JAX package
declines both fused kernels, and so does the port in eval too: the ball
query kernel, the gather, the MLP and a max.

`dtype=torch.bfloat16` (cfg.TPU.COMPUTE_DTYPE=bfloat16) is the JAX
package's bf16 path. The fused SA runs in its bf16 mode (bf16 factors, f32
sums, f32 bias, ReLU and max; pointnet2.py:139-141), which rounds as the
JAX package's XLA path does, not as its TPU kernels round layer 0
(absolute coordinates in bf16; ROADMAP.md queue 3). The rest is as the TPU
runs it: the FP fold's products with bf16 factors and f32 results and the
interpolation's output in bf16 (pointnet2.py:237-258), and, unfolded, the
interpolation and the skip features in bf16 before the concat
(:270-281). Features that arrive in bf16 (the stage-2 up/merge chains)
become f32 exactly: the fused SA casts them, and the concatenation with the
f32 centre offsets promotes them, as in the JAX package. The BN-free
stacks' train path (FusedSA) has no bf16 backward yet.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ws3d_tpu_torch.models.layers import SharedMLP, folded_mlp_params
from ws3d_tpu_torch.ops.fused_sa import fused_sa, fused_sa_train, matmul_bf16
from ws3d_tpu_torch.ops.grouping import (ball_query_multi, group_all,
                                         group_with_idx)
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
                 cin: int, use_bn: bool = True, sorted_points: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.npoint = npoint
        self.radii = [float(r) for r in radii]
        self.nsamples = [int(s) for s in nsamples]
        self.sorted_points = sorted_points
        self.use_bn = use_bn
        self.dtype = dtype
        for i, m in enumerate(mlps):
            self.add_module(f"mlp_{i}", SharedMLP(cin + 3, m, use_bn=use_bn,
                                                  dtype=dtype))
        self.out_channels = sum(int(m[-1]) for m in mlps)

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                train: bool = False, bn_momentum: float = 0.1):
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
        if (train and (self.use_bn or self.npoint is None)) or \
                features is None:
            return new_xyz, self._grouped_forward(xyz, features, new_xyz,
                                                  train, bn_momentum)
        window = use_window(self.sorted_points, xyz.shape[1],
                            features.shape[-1])
        outs = []
        for i in range(len(self.radii)):
            mlp = getattr(self, f"mlp_{i}")
            if self.npoint is None:
                h = mlp(group_all(xyz, features))
                outs.append(torch.amax(h, dim=2))
                continue
            if train:        # BN-free: the live Dense weights, never a cache
                if self.dtype is not None:
                    raise NotImplementedError(
                        "the fused SA has no bf16 backward yet (ROADMAP.md "
                        "queue 1, item 11)")
                kernels, biases = folded_mlp_params(mlp)
                outs.append(fused_sa_train(
                    xyz, features, new_xyz, self.radii[i], self.nsamples[i],
                    kernels, biases, window))
                continue
            kernels, biases = mlp.folded()
            outs.append(fused_sa(
                xyz, features, new_xyz, self.radii[i], self.nsamples[i],
                kernels, biases, window,
                params=mlp.packed() if xyz.is_cuda else None,
                bf16=self.dtype is not None))
        return new_xyz, torch.cat(outs, dim=-1)

    def _grouped_forward(self, xyz, features, new_xyz, train, bn_momentum):
        """ball query (all scales, one launch) -> gather -> MLP (with batch
        statistics in train mode) -> max over S. torch.amax splits the
        gradient evenly among tied samples (the padded duplicates), as JAX's
        max does. Eval runs here only without per-point features
        (RPN.USE_INTENSITY=False), where the JAX package declines both fused
        kernels too."""
        if self.npoint is None:
            grouped = [group_all(xyz, features)] * len(self.radii)
        else:
            idx = ball_query_multi(self.radii, self.nsamples, xyz, new_xyz)
            grouped = [group_with_idx(i.long(), xyz, new_xyz, features)
                       for i in idx]
        outs = [torch.amax(getattr(self, f"mlp_{i}")(
                    g, train=train, bn_momentum=bn_momentum), dim=2)
                for i, g in enumerate(grouped)]
        return torch.cat(outs, dim=-1)


class PointnetFPModule(nn.Module):
    """Feature propagation. Eval uses the layer-0 fold: interpolation is
    linear in the features, so interp(F) @ W0a == interp(F @ W0a); the skip
    rows W0b apply to the unknown features outside. Train runs the MLP on
    [interp(F), skip] with batch statistics. `sorted_points` (both levels
    sorted ascending by z) selects the windowed 3-NN search, kernel 8, in
    both branches; the backbone leaves it off, as the JAX package does."""

    def __init__(self, c_known: int, c_unknown: int, mlp: Sequence[int],
                 use_bn: bool = True, sorted_points: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.c_known = c_known
        self.sorted_points = sorted_points
        self.dtype = dtype
        self.SharedMLP_0 = SharedMLP(c_known + c_unknown, mlp, use_bn=use_bn,
                                     dtype=dtype)

    def forward(self, unknown: torch.Tensor, known: torch.Tensor,
                unknown_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.1) -> torch.Tensor:
        bf16 = self.dtype is not None
        if train:
            h = interpolate_features(unknown, known, known_feats,
                                     sorted_z=self.sorted_points,
                                     bf16_out=bf16)
            if unknown_feats is not None:
                # bf16: the concat stays bf16, as in the JAX package
                h = torch.cat([h, unknown_feats.to(h.dtype)], dim=-1)
            return self.SharedMLP_0(h, train=True, bn_momentum=bn_momentum)
        kernels, biases = self.SharedMLP_0.folded()
        ci = self.c_known
        mm = matmul_bf16 if bf16 else torch.matmul
        feats_f = mm(known_feats, kernels[0][:ci]).contiguous()
        h = interpolate_features(unknown, known, feats_f,
                                 sorted_z=self.sorted_points,
                                 bf16_out=bf16).float()
        if unknown_feats is not None:
            h = h + mm(unknown_feats, kernels[0][ci:])
        h = torch.relu(h + biases[0])
        for W, b in zip(kernels[1:], biases[1:]):
            h = torch.relu(mm(h, W) + b)
        return h
