"""PointRCNN facade (port of ws3d_tpu/models/detector.py): the enabled
stages and one method per stage, as the two-stage pipeline calls them."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ws3d_tpu_torch.device import resolve_device
from ws3d_tpu_torch.models.rcnn import RCNNNet
from ws3d_tpu_torch.models.rpn import RPN


class PointRCNN(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        assert cfg.RPN.ENABLED or cfg.RCNN.ENABLED or cfg.IOUN.ENABLED
        self.rpn: Optional[RPN] = RPN(cfg) if cfg.RPN.ENABLED else None
        self.rcnn: Optional[RCNNNet] = (
            RCNNNet(cfg) if (cfg.RCNN.ENABLED or cfg.IOUN.ENABLED) else None)

    def rpn_forward(self, batch):
        return self.rpn(batch["pts_input"])

    def rcnn_trunk_forward(self, batch):
        return self.rcnn.trunk(batch["cur_box_point"],
                               batch["cur_box_reflect"], batch["train_mask"])

    def ioun_forward(self, batch):
        return self.rcnn.cascade_fwd(
            batch["cur_box_point"], batch["cur_box_reflect"],
            batch["train_mask"], batch["pred_boxes3d"])


def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seed: He-normal kernels, zero biases, identity
    BatchNorm statistics (the JAX package's init, not its random bits)."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".kernel"):
                std = math.sqrt(2.0 / p.shape[0])
                p.copy_(torch.randn(p.shape, generator=gen) * std)
            elif name.endswith(".scale"):
                p.fill_(1.0)
            else:
                p.zero_()
    return model


def build_model(cfg, device=None, seed: int = 0) -> PointRCNN:
    """The facade per cfg.{RPN,RCNN,IOUN}.ENABLED with seeded random
    weights, in eval mode on `device` (CUDA unless the caller asks for the
    CPU). Load fitted weights with ws3d_tpu_torch.weights.load_npz."""
    device = resolve_device(device)
    model = init_random(PointRCNN(cfg), seed)
    return model.to(device).eval()
