"""One whole IOUN-cascade train step against the JAX package (CASCADE 1,
the trunk frozen), from the fitted npz's stage-2 entries and the same TRAIN
crop batch with its cascade jitter. The loss agrees within 1e-4 relative
and every cascade gradient within 1e-3 of its tensor's largest magnitude.
The JAX trunk gradients are exactly zero, so optax's clip over every
gradient equals the port's clip over the cascade alone; the port updates
exactly the parameters of the JAX mask and leaves the trunk bit-unchanged."""
import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_port_helpers import (assert_gradients_match, jax_stage2_gradients,
                                stage2_batch, torch_stage2_model)
from ws3d_tpu_torch.training import Trainer
from ws3d_tpu_torch.training.trainer import (batch_to_device, rcnn_gradients,
                                             step_inputs,
                                             trainable_parameters)
from ws3d_tpu_torch.weights import npz_key


@pytest.fixture(scope="module")
def step():
    batch = stage2_batch("ioun")
    ref = jax_stage2_gradients("ioun", batch)
    model, cfg = torch_stage2_model("ioun")
    params = trainable_parameters(model, "ioun")
    loss, aux, grads = rcnn_gradients(
        model, cfg, "ioun", batch_to_device(batch, "cpu",
                                            step_inputs("ioun", batch)),
        None, 0.1, params)
    got = (float(loss), {k: v.numpy() for k, v in aux.items()},
           {npz_key(k): g.numpy() for k, g in grads.items()})
    return batch, ref, got


def _jax_mask():
    from ws3d_tpu.config import load_config
    from ws3d_tpu.models import build_model, init_model
    from ws3d_tpu.training.trainer import _ioun_trainable_mask
    from torch_port_helpers import stage2_cfg
    cfg = stage2_cfg(load_config, "ioun")
    model = build_model(cfg)
    variables = init_model(model, cfg, jax.random.PRNGKey(0))
    mask = flatten_dict(_ioun_trainable_mask(variables["params"]))
    return {"params/" + "/".join(k): bool(v) for k, v in mask.items()}


def test_batch_carries_the_cascade_jitter(step):
    batch, _, _ = step
    assert batch["iou_trans"].shape == (4, 3, 1)
    assert np.abs(batch["iou_trans"]).max() > 0
    assert 0 < batch["cls"].sum() < len(batch["cls"])


def test_loss_matches(step):
    _, (rl, raux, _), (gl, gaux, _) = step
    np.testing.assert_allclose(gl, rl, rtol=1e-4)
    for k in ("loss_iou", "ioun_loss_loc", "ioun_loss_siz", "ioun_loss_ang"):
        np.testing.assert_allclose(gaux[k], raux[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_trunk_gradients_are_zero_and_cascade_ones_match(step):
    _, (_, _, rg), (_, _, gg) = step
    mask = _jax_mask()
    assert set(mask) == set(rg)
    trunk = [k for k, trainable in mask.items() if not trainable]
    assert trunk and all(not np.any(rg[k]) for k in trunk)
    assert set(gg) == {k for k, trainable in mask.items() if trainable}
    assert_gradients_match(gg, rg)
    # the global norm optax clips by equals the one over the cascade alone
    full = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in rg.values()))
    cascade = np.sqrt(sum(float(np.sum(rg[k].astype(np.float64) ** 2))
                          for k in gg))
    assert full == cascade


def test_a_step_leaves_the_trunk_unchanged():
    batch = stage2_batch("ioun")
    model, cfg = torch_stage2_model("ioun")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, cfg, total_steps=10, stage="ioun",
                      log_fn=lambda s: 0)
    trainer.train_steps([batch], total_steps=1, prefetch_size=0)
    assert trainer.step == 1
    moved = {k for k, v in model.state_dict().items()
             if not torch.equal(v, before[k])}
    trained = set(trainer.optimizer.params)
    assert moved and moved <= trained
    for k, v in model.state_dict().items():
        if k not in trained:
            assert torch.equal(v, before[k]), k
