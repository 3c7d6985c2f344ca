"""The stage-2 RCNN train step in plain tensor code, and the initial
weights that the benchmark makes for both sides.

A step: the trunk's forward on a crop batch (no BatchNorm and no dropout
in this configuration, so train and eval forwards agree), the RCNN loss,
the gradients of every stage-2 parameter by autograd (a parameter the loss
does not reach gets zero), then the optimizer's update
(benchmark/reference/optim.py). Weights: Dense kernels drawn from one
normal draw on the device, scaled to variance 2 / fan_in (He), biases
zero.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.reference import losses
from benchmark.reference.net import Net
from benchmark.reference.optim import AdamOneCycle

INPUTS = ("cur_box_point", "cur_box_reflect", "train_mask", "gt_boxes",
          "cls")


class Tree(dict):
    """A configuration tree with attribute access, as the optimizer and
    the loader copies read it."""

    def __getattr__(self, name):
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return Tree(v) if isinstance(v, dict) else v


def initial_weights(shapes: Dict[str, tuple], seed: int,
                    device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the named shapes: kernels (names ending in
    `kernel`) He-normal from one draw of a generator on `device` seeded
    with `seed`, every other tensor zero."""
    names = sorted(shapes)
    kernels = [n for n in names if n.endswith("kernel")]
    total = sum(int(torch.Size(shapes[n]).numel()) for n in kernels)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    out, lo = {}, 0
    for n in names:
        shape = torch.Size(shapes[n])
        if n in kernels:
            k = flat[lo:lo + shape.numel()].reshape(shape)
            out[n] = k * (2.0 / shape[0]) ** 0.5
            lo += shape.numel()
        else:
            out[n] = torch.zeros(shape, device=device)
    return out


def step_loss(net: Net, tree: dict, batch: Dict[str, torch.Tensor]):
    r = tree["RCNN"]
    out = net.trunk(batch["cur_box_point"], batch["cur_box_reflect"],
                    batch["train_mask"])
    anchor = torch.tensor([float(v) for v in tree["CLS_MEAN_SIZE"][0]],
                          device=batch["gt_boxes"].device)
    total, _ = losses.rcnn_loss(
        out["rcnn_cls"], out["rcnn_reg"], out["pred_boxes3d"].reshape(-1, 7),
        batch["gt_boxes"].reshape(-1, 7), batch["cls"].reshape(-1), anchor,
        loc_scope=r["LOC_SCOPE"], loc_bin_size=r["LOC_BIN_SIZE"],
        num_head_bin=r["NUM_HEAD_BIN"], get_xz_fine=r["LOC_XZ_FINE"])
    return total


def run_steps(params: Dict[str, torch.Tensor], tree: dict,
              batches: List[Dict[str, torch.Tensor]], total_steps: int,
              quant=None) -> dict:
    """The steps on `batches` from `params` (trained in place): each
    step's loss, the first gradient as the optimizer takes it (clipped),
    and the parameters after the steps."""
    for p in params.values():
        p.requires_grad_(True)
    net = Net(params, tree, quant)
    opt = AdamOneCycle(Tree(tree), total_steps, params.items())
    losses_, first = [], None
    for batch in batches:
        total = step_loss(net, tree, batch)
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        losses_.append(float(total.detach()))
        opt.step(grads)
        if first is None:
            b1 = opt.mom(0)
            first = {k: (v / (1.0 - b1)).detach().clone()
                     for k, v in opt.mu.items()}
    return {"losses": losses_, "first_grad": first,
            "params": {k: p.detach().clone() for k, p in params.items()}}


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}
