"""The stage-1 RPN train step in plain tensor code (PointRCNN's stage 1,
Shi et al., CVPR 2019, as WS3D trains it from centre clicks), and the
initial weights that the benchmark makes for both sides. It imports
nothing of the port.

The forward is net.Net's stage 1 (the Pointnet2MSG backbone, its four
multi-scale SA stages and four FP stages, the cls and reg heads) with
BatchNorm in train mode: each BatchNorm normalises with the mean and the
biased variance over every axis but the channels and moves its running
statistics by TRAIN.BN_MOMENTUM. Dropout (RPN.DP_RATIO) follows the ReLU of
each head's first hidden layer, its mask drawn by torch.rand from a
generator on the device seeded with the run's dropout seed, cls head
first. The loss: the sigmoid focal loss (alpha FOCAL_ALPHA[0], gamma
FOCAL_GAMMA) on the Gaussian soft labels, weighted by one over the labels'
sum, plus the bin-based x/z centre loss (cross entropy on the bin, smooth
L1 on the normalised residual of the label's bin) over the points whose
label is at least float32's smallest normal. Then AdamOneCycle
(benchmark/reference/optim.py) over every parameter, the BatchNorm
statistics excluded. The ball query and 3-NN are benchmark/reference/
ops.py's, computed in blocks of centres and of unknown points.

Departures from the published description, each as the port has it:
- the points are sorted by z and the sampled centres kept in index order
  (TPU.SORT_POINTS_Z);
- the heads' hidden layers have no bias (BatchNorm follows them) and the
  running variance is the biased one;
- a label that underflows float32's normal range counts as background in
  the centre loss;
- weights: He-normal kernels from one normal draw on the device, zero
  biases, identity BatchNorm, the cls head's last bias the focal prior
  -log(99) and the reg head's last kernel drawn with standard deviation
  0.001 (PointRCNN's init; the kernels' draw is this benchmark's own).
Callers turn TF32 off (net.f32_matmuls).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from benchmark.reference.losses import (masked_mean, sigmoid_cross_entropy,
                                        smooth_l1, softmax_cross_entropy_int)
from benchmark.reference.net import Net
from benchmark.reference.optim import AdamOneCycle
from benchmark.reference.train import Tree, initial_weights

INPUTS = ("pts_input", "rpn_cls_label", "rpn_reg_label")
FOCAL_PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
REG_FINAL_STD = 0.001
BUFFERS = (".mean", ".var")


def rpn_initial_weights(shapes: Dict[str, tuple], seed: int,
                        device) -> Dict[str, torch.Tensor]:
    """initial_weights with BatchNorm's scale and running variance at 1,
    the cls head's last bias at the focal prior and the reg head's last
    kernel scaled to a standard deviation of 0.001."""
    out = initial_weights(shapes, seed, device)
    for name, t in out.items():
        if name.endswith((".scale", ".var")):
            t.fill_(1.0)
    last = {h: max(int(n.split(".")[2].split("_")[1]) for n in shapes
                   if n.startswith(f"rpn.{h}.Dense_"))
            for h in ("cls_head", "reg_head")}
    out[f"rpn.cls_head.Dense_{last['cls_head']}.bias"].fill_(
        FOCAL_PRIOR_BIAS)
    k = out[f"rpn.reg_head.Dense_{last['reg_head']}.kernel"]
    k.mul_(REG_FINAL_STD / (2.0 / k.shape[0]) ** 0.5)
    return out


def split(state: Dict[str, torch.Tensor]):
    """-> (trainable parameters, BatchNorm running statistics)."""
    params = {k: v for k, v in state.items() if not k.endswith(BUFFERS)}
    buffers = {k: v for k, v in state.items() if k.endswith(BUFFERS)}
    return params, buffers


class TrainNet(Net):
    """Net with train-mode BatchNorm (bn_train) and the heads' dropout."""

    def __init__(self, params, cfg, generator: Optional[torch.Generator],
                 momentum: float, quant: Optional[Callable] = None,
                 bn_train: bool = True):
        super().__init__(params, cfg, quant)
        self.generator = generator
        self.momentum = float(momentum)
        self.bn_train = bn_train
        self.dp = float(cfg["RPN"]["DP_RATIO"])

    def bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        if not self.bn_train:
            return super().bn(name, x)
        p = self.p
        dims = tuple(range(x.dim() - 1))
        # torch.var and 1 / sqrt, as the measured program rounds them, not
        # the two-pass mean of squares and rsqrt: SA0's first layer turns
        # the last-bit differences between two roundings of the same
        # statistics into flips of near-tied maxima, up to 6 % of that
        # leaf's gradient at 25 scenes on an H100
        mean = torch.mean(x, dim=dims)
        var = torch.var(x, dim=dims, correction=0)
        with torch.no_grad():
            m = self.momentum
            p[name + ".mean"].mul_(1 - m).add_(m * mean)
            p[name + ".var"].mul_(1 - m).add_(m * var)
        inv = torch.reciprocal(torch.sqrt(var + 1e-5))
        return (x - mean) * inv * p[name + ".scale"] + p[name + ".bias"]

    def head(self, prefix: str, h: torch.Tensor) -> torch.Tensor:
        n = self.n_dense(prefix) - 1
        for k in range(n):
            h = self.dense(f"{prefix}.Dense_{k}", h)
            if f"{prefix}.BatchNorm_{k}.scale" in self.p:
                h = self.bn(f"{prefix}.BatchNorm_{k}", h)
            h = torch.relu(h)
            if k == 0 and self.generator is not None and self.dp > 0:
                keep = torch.rand(h.shape, generator=self.generator,
                                  device=h.device) >= self.dp
                h = torch.where(keep, h / (1.0 - self.dp),
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
        return self.dense(f"{prefix}.Dense_{n}", h)


def focal_loss(logits, target, alpha: float, gamma: float):
    """Summed sigmoid focal loss on soft targets, each element weighted by
    one over the targets' sum (at least 1)."""
    w = (target + (1.0 - target)) / torch.clamp(torch.sum(target), min=1.0)
    ce = sigmoid_cross_entropy(logits, target)
    p = torch.sigmoid(logits)
    p_t = target * p + (1.0 - target) * (1.0 - p)
    alpha_w = target * alpha + (1.0 - target) * (1.0 - alpha)
    return torch.sum(torch.pow(1.0 - p_t, gamma) * alpha_w * ce * w)


def bin_loss(pred, label, fg, loc_scope: float, bin_size: float):
    """The x/z bin classification and residual losses over `fg`."""
    n = int((loc_scope + 1e-3) / bin_size) * 2
    loss = 0.0
    for axis, lo in ((0, 0), (2, n)):
        shift = torch.clamp(label[:, axis] + loc_scope, 0.0,
                            loc_scope * 2 - 1e-3)
        bin_label = torch.floor(shift / bin_size).to(torch.int64)
        loss = loss + masked_mean(
            softmax_cross_entropy_int(pred[:, lo:lo + n], bin_label), fg)
        res = (shift - (bin_label.to(shift.dtype) * bin_size
                        + bin_size / 2)) / (bin_size / 2)
        slot = 2 * n + lo
        got = torch.gather(pred[:, slot:slot + n], 1, bin_label[:, None])
        loss = loss + masked_mean(smooth_l1(got[:, 0], res), fg)
    return loss


def step_loss(net: TrainNet, tree: dict, batch: Dict[str, torch.Tensor]):
    rpn = tree["RPN"]
    out = net.rpn(batch["pts_input"])
    logits = out["rpn_cls"].reshape(-1)
    target = batch["rpn_cls_label"].reshape(-1)
    cls = focal_loss(logits, target, float(rpn["FOCAL_ALPHA"][0]),
                     float(rpn["FOCAL_GAMMA"]))
    fg = target >= torch.finfo(target.dtype).tiny
    P = logits.shape[0]
    reg = bin_loss(out["rpn_reg"].reshape(P, -1),
                   batch["rpn_reg_label"].reshape(P, 3), fg,
                   float(rpn["LOC_SCOPE"]), float(rpn["LOC_BIN_SIZE"]))
    reg = torch.where(torch.any(fg), reg, torch.zeros_like(reg))
    w = rpn["LOSS_WEIGHT"]
    return cls * float(w[0]) + reg * float(w[1])


def run_steps(state: Dict[str, torch.Tensor], tree: dict,
              batches: List[Dict[str, torch.Tensor]], total_steps: int,
              dropout_seed: int, quant=None, bn_train: bool = True) -> dict:
    """The steps on `batches` from `state` (parameters and BatchNorm
    statistics, updated in place): each step's loss, the first gradient as
    the optimizer takes it (clipped) and the parameters after the steps."""
    params, _ = split(state)
    for p in params.values():
        p.requires_grad_(True)
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(int(dropout_seed))
    net = TrainNet(state, tree, gen, tree["TRAIN"]["BN_MOMENTUM"], quant,
                   bn_train)
    opt = AdamOneCycle(Tree(tree), total_steps, params.items())
    losses, first = [], None
    for batch in batches:
        total = step_loss(net, tree, batch)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        losses.append(float(total.detach()))
        opt.step(grads)
        if first is None:
            b1 = opt.mom(0)
            first = {k: (v / (1.0 - b1)).detach().clone()
                     for k, v in opt.mu.items()}
        del total, grads
    return {"losses": losses, "first_grad": first,
            "params": {k: p.detach().clone() for k, p in params.items()}}
