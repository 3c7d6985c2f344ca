"""Foreground-segmentation smoke trainer on the port (the flow of
tools/pointnet2_seg.py): Pointnet2MSG in train mode with a per-point
HeadMLP([128] -> 1), the Dice loss on the EVAL loader's box labels (inside
a box 1, else 0) and Adam, on whole scenes. It drives FPS, the ball query,
the grouping and the 3-NN interpolation forward, and the 3-NN search in
the backward.

    python -m ws3d_tpu_torch.tools.pointnet2_seg --synthetic --steps 5 \\
        --points 1024 --cpu

Logs `step i: dice_loss=... fg_soft_iou=...` and the final loss. Runs on
CUDA unless --cpu (or --device cpu).
"""
from __future__ import annotations

import sys
from typing import Iterator

import numpy as np
import torch
from torch import nn

from ws3d_tpu_torch.datasets.rpn_dataset import box_rpn_labels
from ws3d_tpu_torch.losses import dice_loss
from ws3d_tpu_torch.models.backbone import Pointnet2MSG
from ws3d_tpu_torch.models.layers import HeadMLP
from ws3d_tpu_torch.tools.train_rpn import (base_parser, close_log,
                                            make_scene_source, setup)


class SegNet(nn.Module):
    """The backbone of cfg.RPN (not z-sorted, as the JAX tool builds it)
    and the head `seg_head`; module names follow the JAX tool's."""

    def __init__(self, cfg):
        super().__init__()
        sa = cfg.RPN.SA_CONFIG
        self.backbone = Pointnet2MSG(
            1 if cfg.RPN.USE_INTENSITY else 0, sa.NPOINTS, sa.RADIUS,
            sa.NSAMPLE, sa.MLPS, cfg.RPN.FP_MLPS)
        self.seg_head = HeadMLP(int(cfg.RPN.FP_MLPS[0][-1]), [128], 1)

    def forward(self, pts: torch.Tensor, train: bool = False) -> torch.Tensor:
        """pts (B, N, 3+C) -> logits (B, N, 1)."""
        _, feats = self.backbone(pts, train)
        return self.seg_head(feats, train)


def configure(cfg, points: int) -> None:
    """The tool's sizes: `points` a scene, SA centres at 1/4, 1/16, 1/64
    and 1/256 of them."""
    cfg.RPN.NUM_POINTS = points
    cfg.RPN.SA_CONFIG.NPOINTS = [max(points // 4, 8), max(points // 16, 4),
                                 max(points // 64, 2), max(points // 256, 1)]


def seg_batches(ds, batch: int) -> Iterator[dict]:
    """The loader's shuffled EVAL batches, repeating, with `label` (B, N)
    the box labels clipped to {0, 1}."""
    for b in ds.batches(batch, shuffle=True):
        labels = [box_rpn_labels(p[:, :3], g[:c])[0] for p, g, c in
                  zip(b["pts_input"], b["gt_boxes3d"], b["gt_count"])]
        yield {"pts_input": b["pts_input"],
               "label": np.clip(np.stack(labels), 0, 1).astype(np.float32)}


def train_step(net: SegNet, opt, pts: torch.Tensor,
               label: torch.Tensor) -> torch.Tensor:
    """One Adam step on the Dice loss; returns the loss (detached)."""
    opt.zero_grad(set_to_none=True)
    loss = dice_loss(net(pts, train=True), label)
    loss.backward()
    opt.step()
    return loss.detach()


def make_optimizer(net: SegNet, lr: float):
    """Adam with optax.adam's defaults."""
    return torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def main(argv=None) -> int:
    p = base_parser("pointnet2 foreground-segmentation smoke trainer")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--points", type=int, default=4096)
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.002)
    args = p.parse_args(argv)
    cfg, log = setup(args, "pointnet2_seg")
    try:
        configure(cfg, args.points)
        from ws3d_tpu_torch.datasets import RPNDataset
        from ws3d_tpu_torch.device import resolve_device
        from ws3d_tpu_torch.models.detector import init_random
        device = resolve_device("cpu" if args.cpu else args.device)
        src = make_scene_source(args, num_scenes=args.scenes)
        ds = RPNDataset(src, cfg, mode="EVAL", npoints=args.points,
                        seed=args.seed)
        net = init_random(SegNet(cfg), args.seed).to(device)
        opt = make_optimizer(net, args.lr)
        loss = None
        for i, batch in zip(range(args.steps), seg_batches(ds, args.batch)):
            loss = train_step(net, opt,
                              torch.from_numpy(batch["pts_input"]).to(device),
                              torch.from_numpy(batch["label"]).to(device))
            if i % max(args.steps // 20, 1) == 0:
                loss_f = float(loss)
                log.info("step %d: dice_loss=%.4f fg_soft_iou=%.4f", i,
                         loss_f, 1.0 - loss_f)
        if loss is not None:
            log.info("done: final dice_loss=%.4f", float(loss))
        return 0
    finally:
        close_log(log)


if __name__ == "__main__":
    sys.exit(main())
