"""Stage-2 RCNN trunk + IOUN cascade over fixed (B, 512) point crops, eval
(port of ws3d_tpu/models/rcnn.py; context attention stays off as in every
shipped yaml, and the train-time cascade jitter is not ported)."""
from __future__ import annotations

import torch
from torch import nn

from ws3d_tpu_torch.box_codec import (bottom_to_center, center_to_bottom,
                                      decode_box_stage2, refine_box)
from ws3d_tpu_torch.models.layers import HeadMLP, SharedMLP
from ws3d_tpu_torch.models.pointnet2 import PointnetSAModuleMSG
from ws3d_tpu_torch.ops.boxes import rotate_points_along_y

EXTEND_FACTOR = 1.2


class SAStack(nn.Module):
    """Single-scale SA pyramid shared by the trunk and the cascade."""

    def __init__(self, cin: int, npoints, radius, nsample, mlps,
                 use_bn: bool, sorted_points: bool):
        super().__init__()
        self.n = len(npoints)
        for k in range(self.n):
            npoint = None if int(npoints[k]) == -1 else int(npoints[k])
            sa = PointnetSAModuleMSG(npoint, [radius[k]], [nsample[k]],
                                     [mlps[k]], cin, use_bn=use_bn,
                                     sorted_points=sorted_points)
            self.add_module(f"sa_{k}", sa)
            cin = sa.out_channels
        self.out_channels = cin

    def forward(self, xyz, features):
        for k in range(self.n):
            xyz, features = getattr(self, f"sa_{k}")(xyz, features)
        return features                                     # (B, 1, C_last)


class RCNNNet(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        if not cfg.RCNN.ROI_SAMPLE_JIT:
            raise NotImplementedError("RCNN.ROI_SAMPLE_JIT=False is not "
                                      "supported")
        if cfg.ATTENTION:
            raise NotImplementedError("context attention is not ported")
        r, io = cfg.RCNN, cfg.IOUN
        self.register_buffer("mean_size", torch.tensor(
            [float(v) for v in cfg.CLS_MEAN_SIZE[0]]), persistent=False)
        self.loc_scope = r.LOC_SCOPE
        self.loc_bin_size = r.LOC_BIN_SIZE
        self.num_head_bin = r.NUM_HEAD_BIN
        sorted_points = bool(cfg.TPU.get("SORT_POINTS_Z", True))
        up = [int(c) for c in r.XYZ_UP_LAYER]
        self.xyz_up = SharedMLP(3, up, use_bn=r.USE_BN)
        self.feature_up = SharedMLP(2, up, use_bn=r.USE_BN)
        self.merge_down = SharedMLP(2 * up[-1], [up[-1]], use_bn=r.USE_BN)
        sa = r.SA_CONFIG
        self.sa_stack = SAStack(up[-1], sa.NPOINTS, sa.RADIUS, sa.NSAMPLE,
                                sa.MLPS, r.USE_BN, sorted_points)
        c = self.sa_stack.out_channels
        per_loc_bin_num = int(r.LOC_SCOPE / r.LOC_BIN_SIZE) * 2
        reg_channels = per_loc_bin_num * 4 + r.NUM_HEAD_BIN * 2 + 3 + 1
        self.cls_head = HeadMLP(c, r.CLS_FC, 1, use_bn=r.USE_BN)
        self.reg_head = HeadMLP(c, r.REG_FC, reg_channels, use_bn=r.USE_BN)
        self.ioun_enabled = bool(io.ENABLED)
        self.cascade = int(cfg.CASCADE)
        self.sorted_points = sorted_points
        if not self.ioun_enabled:
            return
        isa = io.SA_CONFIG
        for k in range(self.cascade):
            self.add_module(f"can_xyz_up_{k}",
                            SharedMLP(3, up, use_bn=io.USE_BN))
            self.add_module(f"can_feature_up_{k}",
                            SharedMLP(2, up, use_bn=io.USE_BN))
            self.add_module(f"can_merge_down_{k}",
                            SharedMLP(2 * up[-1], [up[-1]], use_bn=io.USE_BN))
            stack = SAStack(up[-1], isa.NPOINTS, isa.RADIUS, isa.NSAMPLE,
                            isa.MLPS, io.USE_BN, sorted_points)
            self.add_module(f"sa_score_{k}", stack)
            cc = stack.out_channels
            self.add_module(f"iou_head_{k}",
                            HeadMLP(cc, io.CLS_FC, 1, use_bn=io.USE_BN))
            self.add_module(f"icl_head_{k}",
                            HeadMLP(cc, io.CLS_FC, 1, use_bn=io.USE_BN))
            self.add_module(f"ref_head_{k}",
                            HeadMLP(cc, io.REG_FC, 7, use_bn=io.USE_BN))

    def trunk(self, cur_box_point, cur_box_reflect, train_mask):
        """Up/merge MLPs, SA pyramid, cls/reg heads, in-graph box decode.
        Boxes bottom-y in the crop frame."""
        B = cur_box_point.shape[0]
        raw = torch.cat([cur_box_reflect, train_mask], dim=-1)
        merged = self.merge_down(torch.cat(
            [self.xyz_up(cur_box_point), self.feature_up(raw)], dim=-1))
        trunk = self.sa_stack(cur_box_point.contiguous(), merged.contiguous())
        rcnn_cls = self.cls_head(trunk).reshape(B)
        rcnn_reg = self.reg_head(trunk).reshape(B, -1)
        zero_roi = torch.zeros((B, 3), dtype=rcnn_reg.dtype,
                               device=rcnn_reg.device)
        pred = decode_box_stage2(
            zero_roi, rcnn_reg, self.mean_size, loc_scope=self.loc_scope,
            loc_bin_size=self.loc_bin_size, num_head_bin=self.num_head_bin)
        return {"rcnn_cls": rcnn_cls, "rcnn_reg": rcnn_reg,
                "pred_boxes3d": pred}

    def cascade_fwd(self, cur_box_point, cur_box_reflect, train_mask,
                    pred_boxes3d):
        """IOUN cascade from a trunk box (B, 7) bottom-y in the crop frame:
        canonicalise into the box frame, zero points beyond EXTEND_FACTOR,
        stable z re-sort, fresh up/merge + SA stack, IoU/ICL/ref heads."""
        B = cur_box_point.shape[0]
        raw = torch.cat([cur_box_reflect, train_mask], dim=-1)
        out = {}
        boxes_ce = bottom_to_center(pred_boxes3d)
        rcnn_ref = None
        for c in range(self.cascade):
            if c != 0:
                boxes_ce = refine_box(boxes_ce, rcnn_ref)
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
                [getattr(self, f"can_xyz_up_{c}")(canon),
                 getattr(self, f"can_feature_up_{c}")(feats)], dim=-1))
            feat = getattr(self, f"sa_score_{c}")(canon.contiguous(),
                                                  c_merged.contiguous())
            rcnn_iou = getattr(self, f"iou_head_{c}")(feat)
            ioun_cls = getattr(self, f"icl_head_{c}")(feat)
            rcnn_ref = getattr(self, f"ref_head_{c}")(feat).reshape(B, 7)
            pred = center_to_bottom(boxes_ce)
            out = {"rcnn_iou": rcnn_iou.reshape(B),
                   "ioun_cls": ioun_cls.reshape(B), "rcnn_ref": rcnn_ref,
                   "pred_boxes3d": pred,
                   "refined_box": refine_box(pred, rcnn_ref)}
        return out
