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

    def rpn_forward(self, batch, train: bool = False,
                    bn_momentum: float = 0.1,
                    generator: Optional[torch.Generator] = None):
        return self.rpn(batch["pts_input"], train, bn_momentum, generator)

    def rcnn_forward(self, batch, train: bool = False,
                     bn_momentum: float = 0.1,
                     generator: Optional[torch.Generator] = None):
        """The stage-2 net on a crop batch; the batch's iou_trans/iou_scale/
        iou_ry, where present, jitter the cascade's box."""
        iou_noise = None
        if "iou_trans" in batch:
            iou_noise = {"trans": batch["iou_trans"],
                         "scale": batch["iou_scale"], "ry": batch["iou_ry"]}
        return self.rcnn(batch["cur_box_point"], batch["cur_box_reflect"],
                         batch["train_mask"], iou_noise=iou_noise,
                         train=train, bn_momentum=bn_momentum,
                         generator=generator)

    def rcnn_trunk_forward(self, batch):
        return self.rcnn.trunk(batch["cur_box_point"],
                               batch["cur_box_reflect"], batch["train_mask"])

    def ioun_forward(self, batch):
        return self.rcnn.cascade_fwd(
            batch["cur_box_point"], batch["cur_box_reflect"],
            batch["train_mask"], batch["pred_boxes3d"])


# stddev of a unit normal truncated to [-2, 2]; flax's truncated-normal
# variance scaling divides by it
_TRUNC_STD = 0.87962566103423978


def init_random(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from a seed, in the JAX package's distributions (not
    its random bits): Dense kernels He-normal as flax draws it (a normal
    truncated to two standard deviations, scaled to variance 2 / fan_in),
    zero biases, identity BatchNorm; the RPN cls head's final bias is
    FOCAL_PRIOR_BIAS and the reg head's final kernel N(0, 0.001)
    (ws3d_tpu/models/rpn.py). The stage-2 layers take He-normal too."""
    from ws3d_tpu_torch.models.rpn import FOCAL_PRIOR_BIAS
    gen = torch.Generator().manual_seed(int(seed))
    finals = {}
    if getattr(model, "rpn", None) is not None:
        for head in ("cls_head", "reg_head"):
            n = getattr(model.rpn, head).n_hidden
            finals[f"rpn.{head}.Dense_{n}"] = head
    with torch.no_grad():
        for name, p in model.named_parameters():
            layer, leaf = name.rsplit(".", 1)
            head = finals.get(layer)
            if leaf == "kernel" and head == "reg_head":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.001)
            elif leaf == "kernel":
                std = math.sqrt(2.0 / p.shape[0]) / _TRUNC_STD
                nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.mul_(std)
            elif leaf == "scale":
                p.fill_(1.0)
            elif head == "cls_head":
                p.fill_(FOCAL_PRIOR_BIAS)
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
