"""Rank functions of the data-parallel tests (tests/test_torch_parallel_*.py).

ws3d_tpu_torch.parallel.launch runs them in spawned processes, one a rank
(gloo on the CPU); this module imports the port and never JAX, so a rank
starts in a few seconds.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from torch_card_helpers import WEIGHTS
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.parallel import data_parallel_infer, shard_batch_multihost
from ws3d_tpu_torch.parallel.dryrun import cpu_state
from ws3d_tpu_torch.parallel.dryrun import one_step as step_from
from ws3d_tpu_torch.pipeline import make_two_stage_fn
from ws3d_tpu_torch.training import Trainer
from ws3d_tpu_torch.weights import load_flat, load_npz


def one_step(cfg, stage: str, flat: dict, batch: dict, group=None,
             jit: bool = False):
    """(state, scalar aux, the gradients the optimizer applied) of one step
    from the weights `flat`: single-process on the CPU, or with a group the
    data-parallel step on the rank's shard of `batch` (with `jit` the
    global-batch step)."""
    model = build_model(cfg, device="cpu" if group is None else group.device)
    load_flat(model, flat)
    return step_from(cfg, stage, model, batch, group, jit)[:3]


def train_rank(group, cfg, stage: str, flat: dict, batch: dict,
               per: int) -> dict:
    """One data-parallel step on identical shards (the first `per` samples
    on every rank) and two on the whole batch, each from `flat`."""
    tiled = {k: np.concatenate([v[:per]] * group.world_size)
             for k, v in batch.items()}
    return {"tiled": one_step(cfg, stage, flat, tiled, group),
            "full": one_step(cfg, stage, flat, batch, group),
            "full2": one_step(cfg, stage, flat, batch, group)[0]}


def multihost_rank(group, cfg, flat: dict, full: dict) -> dict:
    """Each rank passes only its contiguous slice of the global batch
    through shard_batch_multihost, then one Trainer step."""
    per = len(full["pts_input"]) // group.world_size
    local = {k: v[group.rank * per:(group.rank + 1) * per]
             for k, v in full.items()}
    shard = shard_batch_multihost(local, group)
    model = build_model(cfg, device=group.device)
    load_flat(model, flat)
    trainer = Trainer(model, cfg, total_steps=4, group=group,
                      log_fn=lambda msg: None)
    history = trainer.train_steps([shard], total_steps=1, log_every=1,
                                  prefetch_size=0)
    return {"global_size": shard.global_size,
            "local_size": len(shard["pts_input"]),
            "loss": history[0]["loss"], "state": cpu_state(model)}


def infer_rank(group, runs: dict, max_proposals: int) -> dict:
    """make_two_stage_fn with the fitted npz on each (config, pts) of
    `runs`, data parallel over the scenes of pts (the stage-2 budget
    pooled over the group)."""
    model = build_model(next(iter(runs.values()))[0], device=group.device)
    load_npz(model, WEIGHTS)
    got = {}
    for name, (cfg, pts) in runs.items():
        fn = make_two_stage_fn(model, cfg, max_proposals=max_proposals,
                               group=group)
        out = data_parallel_infer(fn, group)(torch.from_numpy(pts))
        got[name] = {k: v.cpu() for k, v in out.items()}
    return got


def unequal_slices_rank(group) -> None:
    """Rank r passes r + 1 samples: shard_batch_multihost must refuse."""
    shard_batch_multihost({"x": np.zeros((group.rank + 1, 3), np.float32)},
                          group)


def global_rank(group, cases: dict) -> dict:
    """For each case {name: (cfg, stage, flat, batch)} one global-batch step
    (data_parallel_jit) on the rank's shard of the batch, and for the
    stage-1 cases the per-rank step (data_parallel_step) on the same
    shards."""
    out = {}
    for name, (cfg, stage, flat, batch) in cases.items():
        out[name] = {"jit": one_step(cfg, stage, flat, batch, group,
                                     jit=True)}
        if stage == "rpn":
            out[name]["step"] = one_step(cfg, stage, flat, batch, group)
    return out


def bn_relu_rank(group, state: dict, channels: list, x: torch.Tensor,
                 w: torch.Tensor) -> dict:
    """A SharedMLP's train step in a global batch, on the rank's rows of x
    on its device, twice from `state`: through SharedMLP.forward
    (BatchNorm.relu: on the card the kernels of ops/batchnorm.py) and
    through the composition, BatchNorm's own forward then torch.relu. The
    global loss sums out * w over the whole batch. Each side's output, BN
    state, parameter and input gradients, and BatchNorm + ReLU launches."""
    from ws3d_tpu_torch.models.layers import SharedMLP
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.parallel.global_batch import batch_sum, global_batch
    per = x.shape[0] // group.world_size
    rows = slice(group.rank * per, (group.rank + 1) * per)
    xs, ws = x[rows].to(group.device), w[rows].to(group.device)
    keys = ("bn_relu", "bn_relu_sums", "bn_relu_dx")

    def side(fused: bool) -> dict:
        mlp = SharedMLP(x.shape[-1], channels)
        mlp.load_state_dict(state)
        mlp.to(group.device)
        xl = xs.clone().requires_grad_(True)
        before = dict(_kernels.LAUNCHES)
        with global_batch(group):
            if fused:
                out = mlp(xl, train=True, bn_momentum=0.05)
            else:
                out = xl
                for k in range(len(channels)):
                    out = getattr(mlp, f"Dense_{k}")(out)
                    out = torch.relu(getattr(mlp, f"BatchNorm_{k}")(
                        out.float(), True, 0.05))
            params = [p for _, p in sorted(mlp.named_parameters())]
            grads = torch.autograd.grad(batch_sum(torch.sum(out * ws)),
                                        params + [xl])
        return {"out": out.detach().cpu(),
                "state": {k: v.cpu() for k, v in mlp.state_dict().items()},
                "grads": [g.cpu() for g in grads],
                "launches": {k: _kernels.LAUNCHES[k] - before[k]
                             for k in keys}}

    return {"fused": side(True), "composition": side(False)}


def trainer_rank(group, cfg, flat: dict, host: list) -> dict:
    """A data-parallel Trainer from `flat` over the host batches `host`,
    one step a batch: its state and step count."""
    model = build_model(cfg, device=group.device)
    load_flat(model, flat)
    trainer = Trainer(model, cfg, total_steps=1000, seed=0, group=group,
                      log_fn=lambda msg: None)
    trainer.train_steps(host, total_steps=len(host), log_every=1,
                        prefetch_size=0)
    return {"state": cpu_state(model), "step": trainer.step}


def eval_rank(group, cfg, out_dir: str) -> int:
    """eval_auto's run_eval with the fitted npz on 16 synthetic scenes at
    batch 16 into `out_dir`, the stage-2 budget pooled over the group: the
    detections."""
    import logging
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.tools.eval_auto import run_eval
    model = build_model(cfg, device=group.device)
    load_npz(model, WEIGHTS)
    src = SyntheticKitti(num_scenes=16, points_per_scene=20000, seed=3)
    log = logging.getLogger("eval_rank")
    log.addHandler(logging.NullHandler())
    log.propagate = False
    stats = {}
    run_eval(model, cfg, src, RPNDataset(src, cfg, mode="EVAL", seed=0),
             log, scenes=16, batch=16, output_dir=out_dir, no_ap=True,
             group=group, stats=stats)
    return stats["detections"]


def card_rank(group, calls: list) -> list:
    """On the card, with TF32 off: each (rank function, its arguments,
    deterministic) of `calls` in turn, under PyTorch's deterministic
    algorithms where asked; each one's result and the kernel launches it
    made."""
    from torch_card_helpers import deterministic
    from ws3d_tpu_torch.ops import _kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for fn, args, det in calls:
        _kernels.reset_launch_counts()
        with deterministic() if det else contextlib.nullcontext():
            res = fn(group, *args)
        torch.cuda.synchronize(group.device)
        out.append({"out": res, "launches": dict(_kernels.LAUNCHES)})
    return out
