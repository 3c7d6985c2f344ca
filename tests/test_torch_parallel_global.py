"""The global-batch step (ws3d_tpu_torch.parallel.data_parallel_jit) on two
gloo ranks against the single-process step on the whole batch, in f32 and
in bf16: stage 1 on 4 scenes of 2,048 points (rpn_cfg, DP_RATIO 0, the
fitted stage-1 weights) and the IOUN step on 8 crops of 128 points (the
fitted trunk, a seeded cascade), each rank holding half the batch.

f32: the loss within 1e-5 relative, every new BN running statistic within
1e-5 relative (atol 1e-5 of its tensor's largest magnitude: a statistic
near zero), every applied gradient within 1e-3 of its tensor's largest
magnitude (torch_port_helpers.assert_gradients_match). Reduction order
alone moves them: the global step sums each rank's rows, then the ranks'
sums. Read: loss 1.8e-7 relative, BN 1.2e-7 of a tensor's max, gradients
at most 6.7e-5 of theirs.

bf16: that reduction order flips bf16 roundings downstream (see
test_torch_bf16_train_step.py), so stage 1 is held as the bf16 steps are:
the loss within 5e-3 relative, BN statistics within 5e-3 of each tensor's
max, and the median over tensors of the gradient gap (max |diff| / max
|single|) at most half of the port's own bf16-vs-f32 median gap on the
same batch. Read: loss 1.2e-3, BN 5.0e-4, median gap 0.076. The IOUN
stage has no BatchNorm: every gradient within 1e-2 of its tensor's max
(read 4.7e-3).

Both ranks end bit-equal. The per-rank step (data_parallel_step) on the
same shards keeps each rank's BatchNorm statistics, and its BN statistics
and gradients miss the single step's by far more (read: 2.7 % of a BN
tensor's max, gradients a median of 99 %), which these tests would catch.
"""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from torch_port_helpers import (assert_gradients_match, rpn_cfg,
                                rpn_flat_weights, stage2_batch, stage2_cfg,
                                stage2_flat_weights, train_batch)
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.parallel import launch

N_POINTS = 2048
WORLD = 2
DTYPES = ("float32", "bfloat16")


def gap(a, ref):
    return float((a - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


@pytest.fixture(scope="module")
def run():
    scenes = train_batch(4, N_POINTS)
    crops = stage2_batch("ioun", n_crops=8)
    cases = {}
    for dt in DTYPES:
        cases[f"rpn_{dt}"] = (rpn_cfg(load_config, N_POINTS, dt), "rpn",
                              rpn_flat_weights(), scenes)
        cases[f"ioun_{dt}"] = (stage2_cfg(load_config, "ioun", 128, dt),
                               "ioun", stage2_flat_weights(True), crops)
    got = launch(ranks.global_rank, WORLD, cases, device="cpu", timeout=600)
    single = {name: ranks.one_step(*case) for name, case in cases.items()}
    return got, single


def _bn(state):
    return {k: v for k, v in state.items() if k.endswith((".mean", ".var"))}


def test_ranks_end_bit_equal(run):
    got, _ = run
    for name in got[0]:
        s0, s1 = got[0][name]["jit"][0], got[1][name]["jit"][0]
        assert all(torch.equal(s0[k], s1[k]) for k in s0), name
        assert got[0][name]["jit"][1] == got[1][name]["jit"][1], name


@pytest.mark.parametrize("stage", ["rpn", "ioun"])
def test_f32_global_step_equals_the_single_step(run, stage):
    got, single = run
    name = f"{stage}_float32"
    state, aux, grads = got[0][name]["jit"]
    ref_state, ref_aux, ref_grads = single[name]
    np.testing.assert_allclose(aux["loss"], ref_aux["loss"], rtol=1e-5)
    for k in ("rpn_fg_sum",) if stage == "rpn" else ():
        assert aux[k] == ref_aux[k] > 0
    bn = _bn(ref_state)
    assert bool(bn) == (stage == "rpn")
    for k, v in bn.items():
        np.testing.assert_allclose(state[k], v, rtol=1e-5,
                                   atol=1e-5 * float(v.abs().max()),
                                   err_msg=k)
    assert set(grads) == set(ref_grads)
    assert_gradients_match({k: g.numpy() for k, g in grads.items()},
                           {k: g.numpy() for k, g in ref_grads.items()})


def test_bf16_global_step_matches_the_single_step(run):
    got, single = run
    state, aux, grads = got[0]["rpn_bfloat16"]["jit"]
    ref_state, ref_aux, ref_grads = single["rpn_bfloat16"]
    f32_grads = single["rpn_float32"][2]
    np.testing.assert_allclose(aux["loss"], ref_aux["loss"], rtol=5e-3)
    for k, v in _bn(ref_state).items():
        assert gap(state[k], v) <= 5e-3, k
    keys = [k for k in ref_grads if ref_grads[k].abs().max() > 0]
    port = np.median([gap(grads[k], ref_grads[k]) for k in keys])
    own = np.median([gap(ref_grads[k], f32_grads[k]) for k in keys])
    assert port <= 0.5 * own, (port, own)

    state, aux, grads = got[0]["ioun_bfloat16"]["jit"]
    ref_state, ref_aux, ref_grads = single["ioun_bfloat16"]
    np.testing.assert_allclose(aux["loss"], ref_aux["loss"], rtol=1e-5)
    for k, g in ref_grads.items():
        assert gap(grads[k], g) <= 1e-2 or not g.abs().max(), k


def test_per_rank_step_would_fail_these_gates(run):
    """data_parallel_step's per-rank BatchNorm on the same shards misses
    the single step's statistics and gradients by far more."""
    got, single = run
    state, _, grads = got[0]["rpn_float32"]["step"]
    ref_state, _, ref_grads = single["rpn_float32"]
    assert max(gap(state[k], v) for k, v in _bn(ref_state).items()) > 1e-3
    assert max(gap(grads[k], g) for k, g in ref_grads.items()
               if g.abs().max() > 0) > 1e-2
