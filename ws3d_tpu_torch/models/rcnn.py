"""Stage-2 RCNN trunk + IOUN cascade over fixed (B, 512) point crops (port
of ws3d_tpu/models/rcnn.py). cfg.ATTENTION (off in every shipped yaml) adds
the parameter-free context-attention residual before each SA stage of the
trunk and of each cascade stage; the SA kernels read the attended
features.

Train mode (train=True) is an argument of every forward, as in the JAX
package: BatchNorm takes the batch statistics, the heads apply dropout from
the caller's torch.Generator, and the BN-free SA stacks keep their fused
kernels with a backward. The trunk's decoded box is detached (the JAX
package stops its gradient), so the cascade's loss reaches no trunk
parameter. `iou_noise` is the per-stage train-time jitter of the cascade's
box: trans (B, 3, CASCADE) added, scale (B, 3, CASCADE) multiplied, ry
(B, 1, CASCADE) added.

With cfg.TPU.COMPUTE_DTYPE=bfloat16 the up/merge chains, the SA stacks and
the trunk's cls/reg heads compute in bf16 (the BN-free chains return bf16,
rcnn.py:139-149 and :167-178); the IOUN heads stay f32 (:188-199)."""
from __future__ import annotations

import math

import torch
from torch import nn

from ws3d_tpu_torch.box_codec import (bottom_to_center, center_to_bottom,
                                      decode_box_stage2, refine_box)
from ws3d_tpu_torch.config import compute_dtype
from ws3d_tpu_torch.models.layers import HeadMLP, SharedMLP
from ws3d_tpu_torch.models.pointnet2 import PointnetSAModuleMSG
from ws3d_tpu_torch.ops.boxes import rotate_points_along_y

EXTEND_FACTOR = 1.2


def context_attention(features: torch.Tensor) -> torch.Tensor:
    """The context-attention residual (ws3d_tpu/models/rcnn.py:37-56):
    features (B, N, C) -> features + A^T features, A = softmax over the
    source axis i of f_i . f_j / sqrt(C). Plain products, outside every
    kernel, as in the JAX package."""
    logits = torch.matmul(features, features.transpose(1, 2)) / math.sqrt(
        features.shape[-1])
    attn = torch.softmax(logits, dim=1)
    return features + torch.matmul(attn.transpose(1, 2), features)


class SAStack(nn.Module):
    """Single-scale SA pyramid shared by the trunk and the cascade;
    `attention` applies context_attention before each stage."""

    def __init__(self, cin: int, npoints, radius, nsample, mlps,
                 use_bn: bool, sorted_points: bool, dtype=None,
                 attention: bool = False):
        super().__init__()
        self.n = len(npoints)
        self.attention = attention
        for k in range(self.n):
            npoint = None if int(npoints[k]) == -1 else int(npoints[k])
            sa = PointnetSAModuleMSG(npoint, [radius[k]], [nsample[k]],
                                     [mlps[k]], cin, use_bn=use_bn,
                                     sorted_points=sorted_points, dtype=dtype)
            self.add_module(f"sa_{k}", sa)
            cin = sa.out_channels
        self.out_channels = cin

    def forward(self, xyz, features, train: bool = False,
                bn_momentum: float = 0.1):
        for k in range(self.n):
            if self.attention:
                features = context_attention(features)
            xyz, features = getattr(self, f"sa_{k}")(xyz, features, train,
                                                     bn_momentum)
        return features                                     # (B, 1, C_last)


class RCNNNet(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        if not cfg.RCNN.ROI_SAMPLE_JIT:
            raise NotImplementedError("RCNN.ROI_SAMPLE_JIT=False is not "
                                      "supported")
        r, io = cfg.RCNN, cfg.IOUN
        self.register_buffer("mean_size", torch.tensor(
            [float(v) for v in cfg.CLS_MEAN_SIZE[0]]), persistent=False)
        self.loc_scope = r.LOC_SCOPE
        self.loc_bin_size = r.LOC_BIN_SIZE
        self.num_head_bin = r.NUM_HEAD_BIN
        sorted_points = bool(cfg.TPU.get("SORT_POINTS_Z", True))
        dtype = compute_dtype(cfg)
        up = [int(c) for c in r.XYZ_UP_LAYER]
        # the BN-free chains keep their bf16 output for the SA stack
        chain = dict(use_bn=r.USE_BN, dtype=dtype,
                     out_f32=r.USE_BN or dtype is None)
        self.xyz_up = SharedMLP(3, up, **chain)
        self.feature_up = SharedMLP(2, up, **chain)
        self.merge_down = SharedMLP(2 * up[-1], [up[-1]], **chain)
        sa = r.SA_CONFIG
        attention = bool(cfg.ATTENTION)
        self.sa_stack = SAStack(up[-1], sa.NPOINTS, sa.RADIUS, sa.NSAMPLE,
                                sa.MLPS, r.USE_BN, sorted_points, dtype,
                                attention)
        c = self.sa_stack.out_channels
        per_loc_bin_num = int(r.LOC_SCOPE / r.LOC_BIN_SIZE) * 2
        reg_channels = per_loc_bin_num * 4 + r.NUM_HEAD_BIN * 2 + 3 + 1
        self.cls_head = HeadMLP(c, r.CLS_FC, 1, use_bn=r.USE_BN,
                                dp_ratio=r.DP_RATIO, dtype=dtype)
        self.reg_head = HeadMLP(c, r.REG_FC, reg_channels, use_bn=r.USE_BN,
                                dp_ratio=r.DP_RATIO, dtype=dtype)
        self.ioun_enabled = bool(io.ENABLED)
        self.cascade = int(cfg.CASCADE)
        self.sorted_points = sorted_points
        if not self.ioun_enabled:
            return
        isa = io.SA_CONFIG
        chain = dict(use_bn=io.USE_BN, dtype=dtype,
                     out_f32=io.USE_BN or dtype is None)
        for k in range(self.cascade):
            self.add_module(f"can_xyz_up_{k}", SharedMLP(3, up, **chain))
            self.add_module(f"can_feature_up_{k}", SharedMLP(2, up, **chain))
            self.add_module(f"can_merge_down_{k}",
                            SharedMLP(2 * up[-1], [up[-1]], **chain))
            stack = SAStack(up[-1], isa.NPOINTS, isa.RADIUS, isa.NSAMPLE,
                            isa.MLPS, io.USE_BN, sorted_points, dtype,
                            attention)
            self.add_module(f"sa_score_{k}", stack)
            cc = stack.out_channels
            for name, fc, n_out in (("iou_head", io.CLS_FC, 1),
                                    ("icl_head", io.CLS_FC, 1),
                                    ("ref_head", io.REG_FC, 7)):
                self.add_module(f"{name}_{k}", HeadMLP(
                    cc, fc, n_out, use_bn=io.USE_BN, dp_ratio=io.DP_RATIO))

    def trunk(self, cur_box_point, cur_box_reflect, train_mask,
              train: bool = False, bn_momentum: float = 0.1,
              generator=None):
        """Up/merge MLPs, SA pyramid, cls/reg heads, in-graph box decode
        (detached). Boxes bottom-y in the crop frame."""
        B = cur_box_point.shape[0]
        raw = torch.cat([cur_box_reflect, train_mask], dim=-1)
        mode = dict(train=train, bn_momentum=bn_momentum)
        merged = self.merge_down(torch.cat(
            [self.xyz_up(cur_box_point, **mode),
             self.feature_up(raw, **mode)], dim=-1), **mode)
        trunk = self.sa_stack(cur_box_point.contiguous(), merged.contiguous(),
                              **mode)
        rcnn_cls = self.cls_head(trunk, generator=generator,
                                 **mode).reshape(B)
        rcnn_reg = self.reg_head(trunk, generator=generator,
                                 **mode).reshape(B, -1)
        zero_roi = torch.zeros((B, 3), dtype=rcnn_reg.dtype,
                               device=rcnn_reg.device)
        pred = decode_box_stage2(
            zero_roi, rcnn_reg.detach(), self.mean_size,
            loc_scope=self.loc_scope, loc_bin_size=self.loc_bin_size,
            num_head_bin=self.num_head_bin)
        return {"rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg,
                "pred_boxes3d": pred}

    def cascade_fwd(self, cur_box_point, cur_box_reflect, train_mask,
                    pred_boxes3d, iou_noise=None, train: bool = False,
                    bn_momentum: float = 0.1, generator=None):
        """IOUN cascade from a trunk box (B, 7) bottom-y in the crop frame:
        jitter the box (iou_noise), canonicalise into the box frame, zero
        points beyond EXTEND_FACTOR, stable z re-sort, fresh up/merge + SA
        stack, IoU/ICL/ref heads."""
        B = cur_box_point.shape[0]
        raw = torch.cat([cur_box_reflect, train_mask], dim=-1)
        mode = dict(train=train, bn_momentum=bn_momentum)
        out = {}
        boxes_ce = bottom_to_center(pred_boxes3d)
        rcnn_ref = None
        for c in range(self.cascade):
            if c != 0:
                boxes_ce = refine_box(boxes_ce, rcnn_ref)
            if iou_noise is not None:
                boxes_ce = torch.cat([
                    boxes_ce[:, 0:3] + iou_noise["trans"][..., c],
                    boxes_ce[:, 3:6] * iou_noise["scale"][..., c],
                    boxes_ce[:, 6:7] + iou_noise["ry"][..., c]], dim=-1)
            shifted = cur_box_point - boxes_ce[:, None, 0:3]
            canon = rotate_points_along_y(shifted, boxes_ce[:, 6])
            half = torch.stack([boxes_ce[:, 5], boxes_ce[:, 3],
                                boxes_ce[:, 4]], dim=-1) / 2.0
            canon = canon / torch.clamp(half[:, None, :], min=1e-6)
            gate = torch.amax(torch.abs(canon), dim=-1,
                              keepdim=True) > EXTEND_FACTOR
            canon = torch.where(gate, 0.0, canon)
            feats = raw
            if self.sorted_points:
                order = torch.sort(canon[..., 2], dim=1, stable=True).indices
                canon = torch.gather(canon, 1,
                                     order[..., None].expand(-1, -1, 3))
                feats = torch.gather(raw, 1,
                                     order[..., None].expand(-1, -1, 2))
            c_merged = getattr(self, f"can_merge_down_{c}")(torch.cat(
                [getattr(self, f"can_xyz_up_{c}")(canon, **mode),
                 getattr(self, f"can_feature_up_{c}")(feats, **mode)],
                dim=-1), **mode)
            feat = getattr(self, f"sa_score_{c}")(canon.contiguous(),
                                                  c_merged.contiguous(),
                                                  **mode)
            heads = [getattr(self, f"{name}_{c}")(feat, generator=generator,
                                                  **mode)
                     for name in ("iou_head", "icl_head", "ref_head")]
            rcnn_iou, ioun_cls = heads[0], heads[1]
            rcnn_ref = heads[2].reshape(B, 7)
            pred = center_to_bottom(boxes_ce)
            out = {"rcnn_iou": rcnn_iou.reshape(B),
                   "ioun_cls": ioun_cls.reshape(B), "rcnn_ref": rcnn_ref,
                   "pred_boxes3d": pred,
                   "refined_box": refine_box(pred, rcnn_ref)}
        return out

    def forward(self, cur_box_point, cur_box_reflect, train_mask,
                iou_noise=None, train: bool = False, bn_momentum: float = 0.1,
                generator=None):
        """The trunk, then (IOUN enabled) the cascade from its detached box:
        rcnn_cls (B,), rcnn_reg (B, 52), pred_boxes3d (B, 7) and rcnn_iou,
        ioun_cls, rcnn_ref, refined_box; boxes bottom-y in the crop frame."""
        mode = dict(train=train, bn_momentum=bn_momentum, generator=generator)
        out = self.trunk(cur_box_point, cur_box_reflect, train_mask, **mode)
        if self.ioun_enabled:
            out.update(self.cascade_fwd(cur_box_point, cur_box_reflect,
                                        train_mask, out["pred_boxes3d"],
                                        iou_noise=iou_noise, **mode))
        return out
