"""The multi-host input hook, the twin of tests/test_multihost.py: two gloo
ranks each pass only their own half of a global TRAIN batch of 4 scenes
(the port's loader) through shard_batch_multihost and take one Trainer
step. The global batch is the sum of the slices, the loss is finite and
the replicas are bit-equal. Also: NCCL asked for more ranks than visible
CUDA devices raises, and never falls back to gloo."""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_port_helpers import rpn_cfg, rpn_flat_weights
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
from ws3d_tpu_torch.parallel import launch
from ws3d_tpu_torch.parallel.dryrun import max_diff


def test_two_ranks_shard_their_local_halves_and_step():
    cfg = rpn_cfg(load_config, 512)
    src = SyntheticKitti(num_scenes=4, points_per_scene=1200, seed=0)
    ds = RPNDataset(src, cfg, mode="TRAIN", npoints=cfg.RPN.NUM_POINTS)
    full = next(ds.batches(batch_size=4, steps=1))
    full = {k: full[k] for k in ("pts_input", "rpn_cls_label",
                                 "rpn_reg_label")}
    got = launch(ranks.multihost_rank, 2, cfg, rpn_flat_weights(), full,
                 device="cpu", timeout=600)
    for rank in got:
        assert rank["global_size"] == 4 and rank["local_size"] == 2
        assert np.isfinite(rank["loss"])
    assert got[0]["loss"] == got[1]["loss"]
    assert max_diff(got[0]["state"], got[1]["state"]) == 0.0


def test_unequal_local_slices_are_refused():
    with pytest.raises(RuntimeError, match="slices differ in size"):
        launch(ranks.unequal_slices_rank, 2, device="cpu", timeout=300)


def test_nccl_needs_a_card_a_rank(monkeypatch):
    with pytest.raises(RuntimeError, match="2 ranks on this host, 0 CUDA"):
        launch(ranks.unequal_slices_rank, 2, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks on this host, 1 CUDA"):
        launch(ranks.unequal_slices_rank, 2, backend="nccl", device="cuda:0")
