"""The train steps and the step-loop Trainer (port of
ws3d_tpu/training/trainer.py).

Stage 1 (rpn): rpn_forward(train=True) with the epoch's BN momentum and
dropout from the Trainer's torch.Generator, rpn_loss, gradients of every RPN
parameter, then AdamOneCycle. The BatchNorm running statistics are updated
by the forward itself, as the JAX step replaces batch_stats with the ones
its forward returns.

Stage 2: rcnn_forward(train=True) on a crop batch, then rcnn_loss (stage
"rcnn") or ioun_loss (stage "ioun"). The IOUN stage freezes the RCNN trunk:
its optimizer holds only the cascade's parameters (CASCADE_PREFIXES, the
JAX package's _ioun_trainable_mask). optax clips the global norm over every
gradient before it zeroes the frozen ones; that equals clipping over the
cascade alone because the trunk's IOUN gradients are exactly zero (the
trunk's box is detached).

The Trainer logs the scalar aux values every log_every steps (to the log
and, with tb_dir, to a utils.tb.ScalarWriter) and, given a val_fn
(training.validation.make_val_fn), validates at its cadence: each eval
writes {stage}_ckpt_e{k}.pt and the best `score` {stage}_ckpt_best.pt.

Data parallel (group=, a parallel.Group; the JAX steps' axis_name and the
Trainer's mesh=): each rank differentiates its shard of the batch with its
own train-mode BatchNorm statistics, then the step replaces the gradients,
the BN running statistics its forward wrote and every aux value by their
mean over the ranks (_cross_device_mean) before the optimizer clips and
applies the gradients, so every replica applies the same update. Dropout
draws from a generator a rank (parallel.rank_seed). A step built without a
group and run by parallel.data_parallel_jit is the global-batch step:
BatchNorm and the losses reduce over the whole batch, and _gradients takes
the mean of the ranks' gradients (parallel/global_batch.py says why a
mean).

With cfg.TPU.COMPUTE_DTYPE=bfloat16 the forwards compute in bf16 as the JAX
package's do (models/layers.py) and autograd differentiates them; the
parameters, the optimizer state, the BN statistics and the checkpoints stay
float32, and the gradients the optimizer takes are float32.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ws3d_tpu_torch import losses
from ws3d_tpu_torch.models.layers import BatchNorm
from ws3d_tpu_torch.parallel import global_batch
from ws3d_tpu_torch.parallel.mesh import (LocalShard, all_reduce_mean,
                                          data_parallel_step, rank_seed,
                                          replicate)
from ws3d_tpu_torch.training.checkpoint import save_train_state
from ws3d_tpu_torch.training.optim import AdamOneCycle, bn_momentum_schedule
from ws3d_tpu_torch.utils.prefetch import prefetch
from ws3d_tpu_torch.utils.profiling import span
from ws3d_tpu_torch.utils.tb import ScalarWriter

RPN_INPUTS = ("pts_input", "rpn_cls_label", "rpn_reg_label")
RCNN_INPUTS = ("cur_box_point", "cur_box_reflect", "train_mask", "gt_boxes",
               "cls")
IOU_NOISE = ("iou_trans", "iou_scale", "iou_ry")
CASCADE_PREFIXES = ("can_xyz_up_", "can_feature_up_", "can_merge_down_",
                    "sa_score_", "iou_head_", "icl_head_", "ref_head_")
STAGES = ("rpn", "rcnn", "ioun")


def batch_to_device(batch: Dict[str, np.ndarray], device,
                    keys=RPN_INPUTS) -> Dict[str, torch.Tensor]:
    """The step's inputs of a NumPy batch as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])).to(device)
            for k in keys}


def step_inputs(stage: str, batch) -> tuple:
    """The keys of `batch` a step of `stage` reads."""
    if stage == "rpn":
        return RPN_INPUTS
    return RCNN_INPUTS + tuple(k for k in IOU_NOISE if k in batch)


def trainable_parameters(model, stage: str) -> Dict[str, torch.nn.Parameter]:
    """{name: parameter} a stage trains: the RPN's (rpn), the stage-2 net's
    (rcnn), or only the IOUN cascade's (ioun; the trunk is frozen)."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} is not one of {STAGES}")
    if stage == "rpn":
        return dict(model.rpn.named_parameters(prefix="rpn"))
    named = model.rcnn.named_parameters(prefix="rcnn")
    if stage == "rcnn":
        return dict(named)
    return {k: p for k, p in named
            if k.split(".")[1].startswith(CASCADE_PREFIXES)}


def bn_statistics(net: torch.nn.Module) -> list:
    """The running mean and variance of every BatchNorm in `net`."""
    return [t for m in net.modules() if isinstance(m, BatchNorm)
            for t in (m.mean, m.var)]


def _cross_device_mean(grads: Dict[str, torch.Tensor], net: torch.nn.Module,
                       aux: Dict[str, torch.Tensor], group) -> dict:
    """The mean over the ranks of the gradients and of `net`'s BN running
    statistics, in place, and of the aux values (returned as float32): the
    replica mean of nn.DataParallel and of the JAX steps' pmean; BN is not
    synchronised inside the forward."""
    aux = {k: v.float() for k, v in aux.items()}
    all_reduce_mean(list(grads.values()) + bn_statistics(net)
                    + list(aux.values()), group)
    return aux


def _gradients(loss_fn, batch, generator, bn_momentum,
               params: Dict[str, torch.Tensor]):
    """(loss, aux, {name: gradient}); a parameter the loss does not reach
    gets a zero gradient, as jax.grad gives it. Inside a global batch
    (parallel.data_parallel_jit) the gradients are the mean of the ranks'."""
    total, aux = loss_fn(batch, generator, bn_momentum)
    with span("trainer.backward"):
        grads = torch.autograd.grad(total, list(params.values()),
                                    allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params.values(), grads)]
    group = global_batch.active()
    if group is not None:
        all_reduce_mean(grads, group)
    aux = {k: v.detach() for k, v in aux.items()}
    aux["loss"] = total.detach()
    return total.detach(), aux, dict(zip(params, grads))


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
    return _gradients(make_rpn_loss_fn(model, cfg), batch, generator,
                      bn_momentum, params)


def make_rpn_train_step(model, cfg, optimizer: AdamOneCycle,
                        group=None) -> Callable:
    """step(batch, generator, bn_momentum) -> aux: one stage-1 step on the
    optimizer's parameters (the RPN's). Reads nothing back to the host.
    With a group, the step takes the rank's shard and averages over the
    ranks before the update (parallel.data_parallel_step shards a global
    batch for it)."""
    def step(batch, generator, bn_momentum: float = 0.1):
        _, aux, grads = rpn_gradients(model, cfg, batch, generator,
                                      bn_momentum, optimizer.params)
        if group is not None:
            aux = _cross_device_mean(grads, model.rpn, aux, group)
        optimizer.step(grads)
        return aux

    return step


def make_rcnn_loss_fn(model, cfg, stage: str = "rcnn") -> Callable:
    """loss_fn(batch, generator, bn_momentum) -> (total, aux) of a stage-2
    step: rcnn_loss, or ioun_loss for stage "ioun"."""
    anchor = [float(v) for v in cfg.CLS_MEAN_SIZE[0]]
    r = cfg.RCNN

    def loss_fn(batch, generator, bn_momentum):
        out = model.rcnn_forward(batch, train=True, bn_momentum=bn_momentum,
                                 generator=generator)
        gt = batch["gt_boxes"].reshape(-1, 7)
        cls_label = batch["cls"].reshape(-1)
        if stage == "ioun":
            return losses.ioun_loss(
                out["rcnn_iou"], out["rcnn_ref"],
                out["pred_boxes3d"].reshape(-1, 7),
                out["refined_box"].reshape(-1, 7), gt, cls_label)
        return losses.rcnn_loss(
            out["rcnn_cls"], out["rcnn_reg"],
            out["pred_boxes3d"].reshape(-1, 7), gt, cls_label,
            torch.tensor(anchor, dtype=gt.dtype, device=gt.device),
            loc_scope=r.LOC_SCOPE, loc_bin_size=r.LOC_BIN_SIZE,
            num_head_bin=r.NUM_HEAD_BIN, get_xz_fine=r.LOC_XZ_FINE)

    return loss_fn


def rcnn_gradients(model, cfg, stage: str, batch, generator,
                   bn_momentum: float, params: Dict[str, torch.Tensor]):
    """(loss, aux, {name: gradient}) of one stage-2 forward/backward."""
    return _gradients(make_rcnn_loss_fn(model, cfg, stage), batch,
                      generator, bn_momentum, params)


def make_rcnn_train_step(model, cfg, optimizer: AdamOneCycle,
                         stage: str = "rcnn", group=None) -> Callable:
    """step(batch, generator, bn_momentum) -> aux: one stage-2 step on the
    optimizer's parameters. Reads nothing back to the host. With a group,
    as make_rpn_train_step's."""
    def step(batch, generator, bn_momentum: float = 0.1):
        _, aux, grads = rcnn_gradients(model, cfg, stage, batch, generator,
                                       bn_momentum, optimizer.params)
        if group is not None:
            aux = _cross_device_mean(grads, model.rcnn, aux, group)
        optimizer.step(grads)
        return aux

    return step


class Trainer:
    """Step loop for one stage (rpn, rcnn or ioun): AdamOneCycle over the
    stage's trainable parameters, the BN-momentum schedule per epoch,
    dropout from one seeded generator on the model's device.

    With a group (parallel.Group, the JAX Trainer's mesh=) the model is
    broadcast from rank 0, every host batch is the global batch (each rank
    builds the same one from the same seed, or passes the LocalShard of
    parallel.shard_batch_multihost) and each step runs data parallel. Rank
    0 alone logs, writes the scalar writer, runs val_fn and saves
    checkpoints; the others wait for it at a barrier after each
    validation."""

    def __init__(self, model, cfg, total_steps: int, stage: str = "rpn",
                 seed: int = 0, log_fn=print, tb_dir: Optional[str] = None,
                 group=None):
        self.model = model
        self.cfg = cfg
        self.stage = stage
        self.group = group
        self.is_main = group is None or group.is_main
        self.log_fn = log_fn if self.is_main else (lambda msg: None)
        self.writer = ScalarWriter(tb_dir) if tb_dir and self.is_main \
            else None
        self.best_val = None
        self.device = next(model.parameters()).device
        if group is not None:
            replicate(model, group)
        self.optimizer = AdamOneCycle(
            cfg, total_steps, trainable_parameters(model, stage).items())
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(rank_seed(seed, group))
        self.bn_sched = bn_momentum_schedule(cfg)
        step = (make_rpn_train_step(model, cfg, self.optimizer, group)
                if stage == "rpn" else
                make_rcnn_train_step(model, cfg, self.optimizer, stage,
                                     group))
        self.step_fn = step if group is None else data_parallel_step(step,
                                                                     group)

    def _step_batch(self, batch):
        """A host batch as step_fn takes it: the step's inputs on the
        device, or with a group the global batch's step inputs (or the
        LocalShard) for data_parallel_step to shard."""
        keys = step_inputs(self.stage, batch)
        if self.group is None:
            return batch_to_device(batch, self.device, keys)
        if isinstance(batch, LocalShard):
            return batch
        return {k: batch[k] for k in keys}

    @property
    def step(self) -> int:
        return self.optimizer.count

    def recalibrate_bn(self, batch_iter: Iterable, n_batches: int = 20,
                       momentum: float = 0.2) -> int:
        """Re-estimate the BN running statistics at the current weights:
        up to `n_batches` train-mode forwards with `momentum`, no update of
        the weights. Returns the number of batches used: 0, and nothing
        runs, when the stage's network has no BatchNorm. With a group, rank
        0 runs the forwards on the whole host batches (the JAX Trainer's
        unsharded pass) while the others draw the same batches, then the
        statistics are broadcast from rank 0."""
        net = self.model.rpn if self.stage == "rpn" else self.model.rcnn
        if not bn_statistics(net):
            self.log_fn(f"stage {self.stage} has no BatchNorm: nothing to "
                        f"recalibrate")
            return 0
        forward = (self.model.rpn_forward if self.stage == "rpn"
                   else self.model.rcnn_forward)
        used = 0
        with torch.no_grad():
            for batch in batch_iter:
                if used >= n_batches:
                    break
                if self.is_main:
                    forward(batch_to_device(batch, self.device,
                                            step_inputs(self.stage, batch)),
                            train=True, bn_momentum=momentum,
                            generator=self.generator)
                used += 1
        if self.group is not None:
            replicate(net, self.group)
        self.log_fn(f"recalibrated BN stats over {used} batches")
        return used

    @staticmethod
    def prob_mask_ratio(epoch: int, total_epochs: int) -> float:
        """The share of stage-2 batches whose train_mask is the predicted
        one: from 2/3 at epoch 0 up to 1."""
        return min(0.5 + 0.5 * (epoch + total_epochs / 3.0) / total_epochs,
                   1.0)

    def train_steps(self, batch_iter: Iterable, total_steps: int,
                    log_every: int = 10, epoch_size: Optional[int] = None,
                    prefetch_size: int = 2, ckpt_every: Optional[int] = None,
                    ckpt_dir: Optional[str] = None,
                    val_fn: Optional[Callable] = None,
                    val_every: Optional[int] = None):
        """Run `total_steps` steps; every `log_every` steps log the scalar
        aux values (this reads them back) and keep them in the returned
        history; every `ckpt_every` steps (after step 0) write a resume
        checkpoint ckpt_dir/resume_step_{i}.pt.

        With `val_fn(model) -> metric dict`, validate every `val_every`
        steps (default max(total_steps // 20, 1)) and after the last step:
        log the metrics, write them to the scalar writer as val/<key>, save
        ckpt_dir/{stage}_ckpt_e{k}.pt (k counts the evals from 1) and, when
        the metric `score` beats self.best_val's, ckpt_dir/{stage}_ckpt_best
        .pt. The writer is closed at the end."""
        if prefetch_size:
            batch_iter = prefetch(iter(batch_iter), size=prefetch_size)
        if val_fn is not None and not val_every:
            val_every = max(total_steps // 20, 1)
        history = []
        self.best_val = None
        n_eval = 0
        for i, batch in enumerate(batch_iter):
            if i >= total_steps:
                break
            epoch = i // epoch_size if epoch_size else 0
            step = self.step
            with span("trainer.to_device", step):
                inputs = self._step_batch(batch)
            with span("trainer.step", step):
                aux = self.step_fn(inputs, self.generator,
                                   self.bn_sched(epoch))
            if i % log_every == 0:
                vals = {k: float(v) for k, v in aux.items() if v.dim() == 0}
                self.log_fn(f"step {i}: " + " ".join(
                    f"{k}={v:.4f}" for k, v in sorted(vals.items())))
                if self.writer is not None:
                    self.writer.write(i, vals)
                history.append(vals)
            if val_fn is not None and ((i + 1) % val_every == 0
                                       or i == total_steps - 1):
                n_eval += 1
                if self.is_main:
                    self._run_validation(val_fn, i, n_eval, ckpt_dir)
                if self.group is not None:
                    self.group.barrier()
            if (ckpt_every and ckpt_dir and i > 0 and i % ckpt_every == 0
                    and self.is_main):
                save_train_state(os.path.join(ckpt_dir,
                                              f"resume_step_{i}.pt"),
                                 self.model, self.optimizer)
                self.log_fn(f"saved resume checkpoint at step {i}")
        if hasattr(batch_iter, "close"):
            batch_iter.close()
        if self.writer is not None:
            self.writer.close()
            self.writer = None
        return history

    def _run_validation(self, val_fn: Callable, step: int, n_eval: int,
                        ckpt_dir: Optional[str]) -> Dict[str, float]:
        metrics = val_fn(self.model)
        self.log_fn(f"val @ step {step}: " + " ".join(
            f"{k}={v:.4f}" for k, v in sorted(metrics.items())))
        if self.writer is not None:
            self.writer.write(step, {f"val/{k}": v
                                     for k, v in metrics.items()})
        if ckpt_dir:
            save_train_state(os.path.join(
                ckpt_dir, f"{self.stage}_ckpt_e{n_eval}.pt"), self.model,
                self.optimizer)
            score = metrics.get("score")
            if score is not None and (self.best_val is None
                                      or score > self.best_val["score"]):
                self.best_val = {"step": step, **metrics}
                save_train_state(os.path.join(
                    ckpt_dir, f"{self.stage}_ckpt_best.pt"), self.model,
                    self.optimizer)
                self.log_fn(f"new best val score {score:.4f} @ step {step}")
        return metrics
