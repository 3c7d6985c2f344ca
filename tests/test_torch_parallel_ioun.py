"""The IOUN cascade step (the RCNN trunk frozen) data parallel over two
gloo ranks (ws3d_tpu_torch.parallel; the JAX dryrun's second suite) at
tests/test_torch_ioun_step.py's size: 128-point crops of the JAX loader's
TRAIN batch with its cascade jitter, the fitted trunk and the seeded
cascade, 8 crops in all.

On identical shards (4 crops on each rank) the sharded step equals the
port's single-process step on that shard (parameters within 1e-6) and the
JAX package's single-device step (loss rtol 1e-4, every applied gradient
within 1e-3 of its tensor's largest magnitude). On the whole batch the
replica-mean loss is within 15 % of the single step's (each rank
normalises its masked means over its own crops); the replicas are
bit-equal, two calls agree bitwise, and the trunk comes out bit-unchanged
on both ranks."""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_port_helpers import (assert_gradients_match, jax_stage2_gradients,
                                stage2_batch, stage2_cfg, stage2_flat_weights)
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.parallel import launch
from ws3d_tpu_torch.parallel.dryrun import max_diff
from ws3d_tpu_torch.training.trainer import trainable_parameters
from ws3d_tpu_torch.weights import load_flat, npz_key

PER = 4
WORLD = 2


@pytest.fixture(scope="module")
def run():
    batch = stage2_batch("ioun", n_crops=PER * WORLD)
    cfg = stage2_cfg(load_config, "ioun")
    flat = stage2_flat_weights(True)
    got = launch(ranks.train_rank, WORLD, cfg, "ioun", flat, batch, PER,
                 device="cpu", timeout=600)
    shard = {k: v[:PER] for k, v in batch.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks' CPU threads: the same sums
    try:
        single = ranks.one_step(cfg, "ioun", flat, shard)
        full = ranks.one_step(cfg, "ioun", flat, batch)
    finally:
        torch.set_num_threads(threads)
    model = build_model(cfg, device="cpu")
    load_flat(model, flat)
    return batch, got, single, full, model


def test_identical_shards_equal_the_single_step(run):
    _, got, single, _, _ = run
    for rank in got:
        assert max_diff(rank["tiled"][0], single[0]) <= 1e-6
    assert got[0]["tiled"][1]["loss"] == pytest.approx(single[1]["loss"],
                                                       rel=1e-6)


def test_identical_shards_equal_the_jax_step(run):
    batch, got, _, _, _ = run
    ref_loss, ref_aux, ref_grads = jax_stage2_gradients(
        "ioun", {k: v[:PER] for k, v in batch.items()})
    _, aux, grads = got[0]["tiled"]
    np.testing.assert_allclose(aux["loss"], ref_loss, rtol=1e-4)
    grads = {npz_key(k): g.numpy() for k, g in grads.items()}
    assert grads and set(grads) <= set(ref_grads)
    assert_gradients_match(grads, ref_grads)


def test_full_batch_loss_within_15_percent(run):
    _, got, _, full, _ = run
    loss, ref = got[0]["full"][1]["loss"], full[1]["loss"]
    assert np.isfinite(loss)
    assert abs(loss - ref) / abs(ref) < 0.15


def test_replicas_bit_equal_trunk_unchanged(run):
    _, got, _, _, model = run
    for key in ("tiled", "full"):
        assert max_diff(got[0][key][0], got[1][key][0]) == 0.0, key
    assert max_diff(got[0]["full"][0], got[0]["full2"]) == 0.0
    trained = set(trainable_parameters(model, "ioun"))
    before = model.state_dict()
    for rank in got:
        after = rank["full"][0]
        assert any(not torch.equal(after[k], before[k]) for k in trained)
        for k, v in before.items():
            if k not in trained:
                assert torch.equal(after[k], v), k
