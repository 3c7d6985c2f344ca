"""The stage-1 (RPN) train step and the step-loop Trainer (port of the RPN
parts of ws3d_tpu/training/trainer.py).

A step: rpn_forward(train=True) with the epoch's BN momentum and dropout
from the Trainer's torch.Generator, rpn_loss, gradients of every RPN
parameter, then AdamOneCycle. The BatchNorm running statistics are updated
by the forward itself, as the JAX step replaces batch_stats with the ones
its forward returns. TensorBoard output and in-training validation are not
ported.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ws3d_tpu_torch import losses
from ws3d_tpu_torch.training.checkpoint import save_train_state
from ws3d_tpu_torch.training.optim import AdamOneCycle, bn_momentum_schedule
from ws3d_tpu_torch.utils.prefetch import prefetch

RPN_INPUTS = ("pts_input", "rpn_cls_label", "rpn_reg_label")


def batch_to_device(batch: Dict[str, np.ndarray], device,
                    keys=RPN_INPUTS) -> Dict[str, torch.Tensor]:
    """The step's inputs of a NumPy batch as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in keys}


def make_rpn_loss_fn(model, cfg) -> Callable:
    """loss_fn(batch, generator, bn_momentum) -> (total, aux); the forward
    updates the BN running statistics."""
    loc_scope = cfg.RPN.LOC_SCOPE
    loc_bin_size = cfg.RPN.LOC_BIN_SIZE
    alpha = cfg.RPN.FOCAL_ALPHA[0]
    gamma = cfg.RPN.FOCAL_GAMMA
    weights = tuple(cfg.RPN.LOSS_WEIGHT)

    def loss_fn(batch, generator, bn_momentum):
        out = model.rpn_forward({"pts_input": batch["pts_input"]},
                                train=True, bn_momentum=bn_momentum,
                                generator=generator)
        return losses.rpn_loss(
            out["rpn_cls"], out["rpn_reg"], batch["rpn_cls_label"],
            batch["rpn_reg_label"], loc_scope, loc_bin_size,
            focal_alpha=alpha, focal_gamma=gamma, loss_weights=weights)

    return loss_fn


def rpn_gradients(model, cfg, batch, generator, bn_momentum: float,
                  params: Dict[str, torch.Tensor]):
    """(loss, aux, {name: gradient}) of one stage-1 forward/backward."""
    total, aux = make_rpn_loss_fn(model, cfg)(batch, generator, bn_momentum)
    grads = torch.autograd.grad(total, list(params.values()))
    aux = {k: v.detach() for k, v in aux.items()}
    aux["loss"] = total.detach()
    return total.detach(), aux, dict(zip(params, grads))


def make_rpn_train_step(model, cfg, optimizer: AdamOneCycle) -> Callable:
    """step(batch, generator, bn_momentum) -> aux: one stage-1 step on the
    optimizer's parameters (the RPN's). Reads nothing back to the host."""
    def step(batch, generator, bn_momentum: float = 0.1):
        _, aux, grads = rpn_gradients(model, cfg, batch, generator,
                                      bn_momentum, optimizer.params)
        optimizer.step(grads)
        return aux

    return step


class Trainer:
    """Step loop for stage 1: AdamOneCycle over the RPN's parameters, the
    BN-momentum schedule per epoch, dropout from one seeded generator on
    the model's device."""

    def __init__(self, model, cfg, total_steps: int, stage: str = "rpn",
                 seed: int = 0, log_fn=print):
        if stage != "rpn":
            raise NotImplementedError("only stage-1 (rpn) training is "
                                      "ported")
        self.model = model
        self.cfg = cfg
        self.stage = stage
        self.log_fn = log_fn
        self.device = next(model.parameters()).device
        self.optimizer = AdamOneCycle(
            cfg, total_steps, model.rpn.named_parameters(prefix="rpn"))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self.bn_sched = bn_momentum_schedule(cfg)
        self.step_fn = make_rpn_train_step(model, cfg, self.optimizer)

    @property
    def step(self) -> int:
        return self.optimizer.count

    def recalibrate_bn(self, batch_iter: Iterable, n_batches: int = 20,
                       momentum: float = 0.2) -> int:
        """Re-estimate the BN running statistics at the current weights:
        up to `n_batches` train-mode forwards with `momentum`, no update of
        the weights. Returns the number of batches used."""
        used = 0
        with torch.no_grad():
            for batch in batch_iter:
                if used >= n_batches:
                    break
                self.model.rpn_forward(
                    batch_to_device(batch, self.device, ("pts_input",)),
                    train=True, bn_momentum=momentum,
                    generator=self.generator)
                used += 1
        self.log_fn(f"recalibrated BN stats over {used} batches")
        return used

    def train_steps(self, batch_iter: Iterable, total_steps: int,
                    log_every: int = 10, epoch_size: Optional[int] = None,
                    prefetch_size: int = 2, ckpt_every: Optional[int] = None,
                    ckpt_dir: Optional[str] = None):
        """Run `total_steps` steps; every `log_every` steps log the scalar
        aux values (this reads them back) and keep them in the returned
        history; every `ckpt_every` steps (after step 0) write a resume
        checkpoint ckpt_dir/resume_step_{i}.pt."""
        if prefetch_size:
            batch_iter = prefetch(iter(batch_iter), size=prefetch_size)
        history = []
        for i, batch in enumerate(batch_iter):
            if i >= total_steps:
                break
            epoch = i // epoch_size if epoch_size else 0
            aux = self.step_fn(batch_to_device(batch, self.device),
                               self.generator, self.bn_sched(epoch))
            if i % log_every == 0:
                vals = {k: float(v) for k, v in aux.items() if v.dim() == 0}
                self.log_fn(f"step {i}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in sorted(vals.items())))
                history.append(vals)
            if ckpt_every and ckpt_dir and i > 0 and i % ckpt_every == 0:
                save_train_state(os.path.join(ckpt_dir,
                                              f"resume_step_{i}.pt"),
                                 self.model, self.optimizer)
                self.log_fn(f"saved resume checkpoint at step {i}")
        if hasattr(batch_iter, "close"):
            batch_iter.close()
        return history
