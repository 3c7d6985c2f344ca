"""Stage-1 RPN: Pointnet2MSG backbone + per-point cls / centre-vote heads
(port of ws3d_tpu/models/rpn.py)."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ws3d_tpu_torch.config import compute_dtype
from ws3d_tpu_torch.models.backbone import Pointnet2MSG
from ws3d_tpu_torch.models.layers import HeadMLP

# the cls head's final bias, -log((1 - pi) / pi) with pi = 0.01
FOCAL_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class RPN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        dtype = compute_dtype(cfg)
        cin = 1 if cfg.RPN.USE_INTENSITY else 0
        sa = cfg.RPN.SA_CONFIG
        self.backbone = Pointnet2MSG(
            cin, sa.NPOINTS, sa.RADIUS, sa.NSAMPLE, sa.MLPS, cfg.RPN.FP_MLPS,
            use_bn=cfg.RPN.USE_BN,
            sorted_points=bool(cfg.TPU.get("SORT_POINTS_Z", True)),
            dtype=dtype)
        c = int(cfg.RPN.FP_MLPS[0][-1])
        per_loc_bin_num = int(cfg.RPN.LOC_SCOPE / cfg.RPN.LOC_BIN_SIZE) * 2
        dp = float(cfg.RPN.DP_RATIO)
        self.cls_head = HeadMLP(c, cfg.RPN.CLS_FC, 1, use_bn=cfg.RPN.USE_BN,
                                dp_ratio=dp, dtype=dtype)
        self.reg_head = HeadMLP(c, cfg.RPN.REG_FC, per_loc_bin_num * 4,
                                use_bn=cfg.RPN.USE_BN, dp_ratio=dp,
                                dtype=dtype)

    def forward(self, pts: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.1,
                generator: Optional[torch.Generator] = None):
        """pts (B, N, 3+C) -> dict rpn_cls (B, N, 1), rpn_reg (B, N, 40),
        backbone_xyz (B, N, 3), backbone_features (B, N, 128). train=True
        uses batch statistics, updates the BN running statistics with
        `bn_momentum` and draws the heads' dropout from `generator` (cls
        head first, then reg head)."""
        xyz, feats = self.backbone(pts, train, bn_momentum)
        return {"rpn_cls": self.cls_head(feats, train, bn_momentum,
                                         generator),
                "rpn_reg": self.reg_head(feats, train, bn_momentum,
                                         generator),
                "backbone_xyz": xyz, "backbone_features": feats}
