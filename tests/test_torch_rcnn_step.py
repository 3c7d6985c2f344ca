"""One whole stage-2 RCNN train step against the JAX package: the fitted
npz's stage-2 entries and the same TRAIN crop batch (4 crops of 128 points,
NPOINTS 64/32/8/-1 as tools/train_cascade.py scales them, full widths).
The loss agrees within 1e-4 relative and every gradient within 1e-3 of its
tensor's largest magnitude. On the CPU the BN-free SA stages run FusedSA
with the plain forward and the given-index backward; the JAX package takes
its XLA composition there."""
import numpy as np
import pytest

from torch_port_helpers import (assert_gradients_match, jax_stage2_gradients,
                                stage2_batch, torch_stage2_model)
from ws3d_tpu_torch.training.trainer import (batch_to_device, rcnn_gradients,
                                             step_inputs,
                                             trainable_parameters)
from ws3d_tpu_torch.weights import npz_key


@pytest.fixture(scope="module")
def step():
    batch = stage2_batch("rcnn")
    ref = jax_stage2_gradients("rcnn", batch)
    model, cfg = torch_stage2_model("rcnn")
    loss, aux, grads = rcnn_gradients(
        model, cfg, "rcnn", batch_to_device(batch, "cpu",
                                            step_inputs("rcnn", batch)),
        None, 0.1, trainable_parameters(model, "rcnn"))
    got = (float(loss), {k: v.numpy() for k, v in aux.items()},
           {npz_key(k): g.numpy() for k, g in grads.items()})
    return batch, ref, got


def test_batch_has_foreground_and_background(step):
    batch, _, _ = step
    assert 0 < batch["cls"].sum() < len(batch["cls"])


def test_loss_matches(step):
    _, (rl, raux, _), (gl, gaux, _) = step
    np.testing.assert_allclose(gl, rl, rtol=1e-4)
    for k in ("rcnn_loss_cls", "rcnn_loss_loc", "rcnn_loss_angle",
              "rcnn_loss_size", "rcnn_loss_corner", "rcnn_iou_mean"):
        np.testing.assert_allclose(gaux[k], raux[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_every_gradient_matches(step):
    _, (_, _, rg), (_, _, gg) = step
    assert set(gg) == set(rg)
    assert_gradients_match(gg, rg)
