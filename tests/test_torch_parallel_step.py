"""The stage-1 train step data parallel over two gloo ranks
(ws3d_tpu_torch.parallel; the JAX dryrun's first suite) at
tests/test_torch_train_step.py's size: rpn_cfg's 2,048 points, DP_RATIO 0,
the fitted stage-1 weights, the JAX loader's TRAIN batch of 4 scenes. (At
512 points SA3 keeps 2 points a scene, and its BatchNorm over 4 samples
amplifies rounding in both packages: single-process gradients already
differ from JAX's by up to 2.2 % there.)

On identical shards (2 scenes on each rank) the sharded step equals the
port's single-process step on that shard (parameters and BN statistics
within 1e-6) and the JAX package's single-device step (loss rtol 1e-4, BN
statistics rtol/atol 1e-5, every applied gradient within 1e-3 of its
tensor's largest magnitude). On the whole batch (each rank its own 2
scenes) the replica-mean loss is within 5 % of the single step's; the
replicas are bit-equal after a step and two calls agree bitwise."""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_port_helpers import (assert_gradients_match, jax_rpn_gradients,
                                rpn_cfg, rpn_flat_weights, train_batch)
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.parallel import launch
from ws3d_tpu_torch.parallel.dryrun import max_diff
from ws3d_tpu_torch.weights import npz_key

N_POINTS = 2048
PER = 2
WORLD = 2


@pytest.fixture(scope="module")
def run():
    batch = train_batch(PER * WORLD, N_POINTS)
    cfg = rpn_cfg(load_config, N_POINTS)
    flat = rpn_flat_weights()
    got = launch(ranks.train_rank, WORLD, cfg, "rpn", flat, batch, PER,
                 device="cpu", timeout=600)
    shard = {k: v[:PER] for k, v in batch.items()}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # the ranks' CPU threads: the same sums
    try:
        single = ranks.one_step(cfg, "rpn", flat, shard)
        full = ranks.one_step(cfg, "rpn", flat, batch)
    finally:
        torch.set_num_threads(threads)
    return batch, got, single, full


def test_identical_shards_equal_the_single_step(run):
    _, got, single, _ = run
    for rank in got:
        assert max_diff(rank["tiled"][0], single[0]) <= 1e-6
    assert got[0]["tiled"][1]["loss"] == pytest.approx(single[1]["loss"],
                                                       rel=1e-6)


def test_identical_shards_equal_the_jax_step(run):
    batch, got, _, _ = run
    ref_loss, ref_aux, ref_grads, ref_stats = jax_rpn_gradients(
        {k: v[:PER] for k, v in batch.items()}, N_POINTS)
    new_state, aux, grads = got[0]["tiled"]
    assert int(ref_aux["rpn_fg_sum"]) > 0
    np.testing.assert_allclose(aux["loss"], ref_loss, rtol=1e-4)
    grads = {npz_key(k): g.numpy() for k, g in grads.items()}
    assert set(grads) == set(ref_grads)
    assert_gradients_match(grads, ref_grads)
    stats = {npz_key(k): v.numpy() for k, v in new_state.items()
             if npz_key(k).startswith("batch_stats/")}
    assert set(stats) == set(ref_stats)
    for k, v in stats.items():
        np.testing.assert_allclose(v, ref_stats[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_full_batch_loss_within_5_percent(run):
    _, got, _, full = run
    loss, ref = got[0]["full"][1]["loss"], full[1]["loss"]
    assert np.isfinite(loss)
    assert abs(loss - ref) / abs(ref) < 0.05
    # each rank saw other scenes: the replica mean is not the full batch's
    assert max_diff(got[0]["full"][0], full[0]) > 0


def test_replicas_bit_equal_and_deterministic(run):
    _, got, _, _ = run
    for key in ("tiled", "full"):
        assert max_diff(got[0][key][0], got[1][key][0]) == 0.0, key
        assert got[0][key][1] == got[1][key][1], key
    assert max_diff(got[0]["full"][0], got[0]["full2"]) == 0.0
