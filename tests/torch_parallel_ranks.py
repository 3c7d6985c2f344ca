"""Rank functions of the data-parallel tests (tests/test_torch_parallel_*.py).

ws3d_tpu_torch.parallel.launch runs them in spawned processes, one a rank
(gloo on the CPU); this module imports the port and never JAX, so a rank
starts in a few seconds.
"""
from __future__ import annotations

import numpy as np
import torch

from torch_port_helpers import WEIGHTS
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.parallel import data_parallel_infer, shard_batch_multihost
from ws3d_tpu_torch.parallel.dryrun import cpu_state
from ws3d_tpu_torch.parallel.dryrun import one_step as step_from
from ws3d_tpu_torch.pipeline import make_two_stage_fn
from ws3d_tpu_torch.training import Trainer
from ws3d_tpu_torch.weights import load_flat, load_npz


def one_step(cfg, stage: str, flat: dict, batch: dict, group=None):
    """(state, scalar aux, the gradients the optimizer applied) of one step
    from the weights `flat`: single-process on the CPU, or with a group the
    data-parallel step on the rank's shard of `batch`."""
    model = build_model(cfg, device="cpu" if group is None else group.device)
    load_flat(model, flat)
    return step_from(cfg, stage, model, batch, group)[:3]


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
