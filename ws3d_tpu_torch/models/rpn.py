"""Stage-1 RPN: Pointnet2MSG backbone + per-point cls / centre-vote heads
(port of ws3d_tpu/models/rpn.py)."""
from __future__ import annotations

import torch
from torch import nn

from ws3d_tpu_torch.models.backbone import Pointnet2MSG
from ws3d_tpu_torch.models.layers import HeadMLP


class RPN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        if str(cfg.TPU.COMPUTE_DTYPE) != "float32":
            raise NotImplementedError("the port computes in float32 only")
        cin = 1 if cfg.RPN.USE_INTENSITY else 0
        sa = cfg.RPN.SA_CONFIG
        self.backbone = Pointnet2MSG(
            cin, sa.NPOINTS, sa.RADIUS, sa.NSAMPLE, sa.MLPS, cfg.RPN.FP_MLPS,
            use_bn=cfg.RPN.USE_BN,
            sorted_points=bool(cfg.TPU.get("SORT_POINTS_Z", True)))
        c = int(cfg.RPN.FP_MLPS[0][-1])
        per_loc_bin_num = int(cfg.RPN.LOC_SCOPE / cfg.RPN.LOC_BIN_SIZE) * 2
        self.cls_head = HeadMLP(c, cfg.RPN.CLS_FC, 1, use_bn=cfg.RPN.USE_BN)
        self.reg_head = HeadMLP(c, cfg.RPN.REG_FC, per_loc_bin_num * 4,
                                use_bn=cfg.RPN.USE_BN)

    def forward(self, pts: torch.Tensor):
        """pts (B, N, 3+C) -> dict rpn_cls (B, N, 1), rpn_reg (B, N, 40),
        backbone_xyz (B, N, 3), backbone_features (B, N, 128)."""
        xyz, feats = self.backbone(pts)
        return {"rpn_cls": self.cls_head(feats),
                "rpn_reg": self.reg_head(feats),
                "backbone_xyz": xyz, "backbone_features": feats}
