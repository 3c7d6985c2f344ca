"""One stage-1 train step in bf16 (TPU.COMPUTE_DTYPE=bfloat16) against the
JAX package's bf16 step: the fitted npz's stage-1 weights, one TRAIN batch
of 2 scenes x 2,048 points, DP_RATIO 0 on both sides (the inputs of
test_torch_train_step.py).

A per-tensor max gate cannot work here. bf16 alone moves this BatchNorm
network's gradients by a median of about 20 % of each tensor's largest
value (JAX bf16 against JAX f32), and the port's bf16 forward does not round
at every place where JAX's does: BatchNorm's f32 statistics sum in another
order than XLA's (a last-bit difference in every channel), and where a
normalised value lies near a bf16 rounding boundary the next Dense rounds
it the other way (ROADMAP.md queue 3). So the gradients are held by the
median over tensors of the gap max |port - JAX bf16| / max |JAX bf16|:

- at most half of the JAX package's own bf16-vs-f32 median gap
  (max |JAX bf16 - JAX f32| / max |JAX f32|), both computed here on the
  same batch;
- in at least 90 % of the tensors the port's gap is the smaller of the two.

Readings on the CPU: the port's median gap 0.0574 against JAX's 0.201 (a
ratio of 0.286), and the port's gap the smaller in 96.2 % of the 106
tensors. The loss agrees within 5e-3 relative (1.40e-3 read: the port's
bf16 loss 4.95049, JAX's 4.94358, JAX's f32 4.95285) and every new BN
running statistic within 5e-3 of the largest magnitude of its tensor
(6.8e-4 read).
"""
import numpy as np
import pytest

from torch_port_helpers import (jax_rpn_gradients, rpn_cfg, rpn_flat_weights,
                                train_batch)

N_POINTS = 2048
MEDIAN_RATIO = 0.5          # port gap / JAX's own bf16-vs-f32 gap, medians
SMALLER_SHARE = 0.9         # tensors where the port's gap is the smaller
LOSS_RTOL = 5e-3
STATS_TOL = 5e-3            # of each BN statistic tensor's largest value


def gap(a, ref):
    """max |a - ref| over max |ref|: one number a tensor."""
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.fixture(scope="module")
def step():
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training.trainer import (batch_to_device,
                                                 rpn_gradients)
    from ws3d_tpu_torch.weights import load_flat, npz_key

    batch = train_batch(2, N_POINTS)
    ref32 = jax_rpn_gradients(batch, N_POINTS, "float32")
    ref16 = jax_rpn_gradients(batch, N_POINTS, "bfloat16")
    cfg = rpn_cfg(load_config, N_POINTS, "bfloat16")
    model = build_model(cfg, device="cpu")
    load_flat(model, rpn_flat_weights())
    named = dict(model.rpn.named_parameters(prefix="rpn"))
    loss, aux, grads = rpn_gradients(model, cfg,
                                     batch_to_device(batch, "cpu"), None,
                                     0.1, named)
    assert all(p.dtype == torch.float32 for p in named.values())
    got = {"loss": float(loss), "fg": int(aux["rpn_fg_sum"]),
           "grads": {npz_key(k): g.numpy() for k, g in grads.items()},
           "grad_dtypes": {g.dtype for g in grads.values()},
           "stats": {npz_key(k): v.numpy()
                     for k, v in model.state_dict().items()
                     if npz_key(k).startswith("batch_stats/")}}
    return ref32, ref16, got


def test_bf16_loss_matches(step):
    _, (loss16, aux16, _, _), got = step
    assert np.isfinite(got["loss"])
    assert got["fg"] == int(aux16["rpn_fg_sum"]) > 0
    np.testing.assert_allclose(got["loss"], loss16, rtol=LOSS_RTOL)


def test_bf16_gradients_within_jax_own_bf16_gap(step):
    (_, _, g32, _), (_, _, g16, _), got = step
    import torch
    assert got["grad_dtypes"] == {torch.float32}
    assert set(got["grads"]) == set(g16) == set(g32)
    port = np.array([gap(got["grads"][k], g16[k]) for k in sorted(g16)])
    own = np.array([gap(g16[k], g32[k]) for k in sorted(g16)])
    assert np.isfinite(port).all()
    assert np.median(port) <= MEDIAN_RATIO * np.median(own), (
        np.median(port), np.median(own))
    assert np.mean(port < own) >= SMALLER_SHARE, np.mean(port < own)


def test_bf16_bn_statistics_match(step):
    _, (_, _, _, stats16), got = step
    assert set(got["stats"]) == set(stats16)
    for k, v in got["stats"].items():
        assert v.dtype == np.float32, k
        assert gap(v, stats16[k]) <= STATS_TOL, (k, gap(v, stats16[k]))
