"""One whole stage-1 train step against the JAX package: the same fitted
npz weights (stage-1 entries) and the same TRAIN batch (2 scenes of 2,048
points, NPOINTS scaled as tools/train_rpn.py does), DP_RATIO 0 on both
sides. The loss agrees within 1e-4 relative, every gradient within 1e-3 of
its tensor's largest magnitude, and the new BN running statistics within
1e-5. Gradients, not updated weights, are compared: Adam turns a
rounding-level difference in a near-zero gradient into a whole +-lr step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from torch_port_helpers import rpn_cfg, rpn_flat_weights, train_batch
from ws3d_tpu_torch.training.trainer import batch_to_device, rpn_gradients
from ws3d_tpu_torch.weights import load_flat, npz_key

N_POINTS = 2048


def _flat(tree, prefix):
    return {prefix + "/" + "/".join(k): np.asarray(v)
            for k, v in flatten_dict(tree).items()}


@pytest.fixture(scope="module")
def step():
    from ws3d_tpu.config import load_config as jax_config
    from ws3d_tpu.models import build_model as jax_build
    from ws3d_tpu.models import init_model
    from ws3d_tpu.training.trainer import make_rpn_loss_fn
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model

    batch = train_batch(2, N_POINTS)
    flat = rpn_flat_weights()

    jcfg = rpn_cfg(jax_config, N_POINTS)
    jmodel = jax_build(jcfg)
    variables = init_model(jmodel, jcfg, jax.random.PRNGKey(0))
    params = {"params": jax.tree.map(np.asarray, variables["params"]),
              "batch_stats": jax.tree.map(np.asarray,
                                          variables["batch_stats"])}
    from flax.traverse_util import unflatten_dict
    for coll in params:
        f = flatten_dict(params[coll])
        for k in f:
            f[k] = flat[coll + "/" + "/".join(k)]
        params[coll] = unflatten_dict(f)
    jbatch = {k: jnp.asarray(batch[k])
              for k in ("pts_input", "rpn_cls_label", "rpn_reg_label")}
    (loss, (aux, new_bs)), grads = jax.jit(jax.value_and_grad(
        make_rpn_loss_fn(jmodel, jcfg), has_aux=True))(
        params["params"], params["batch_stats"], jbatch,
        jax.random.PRNGKey(1), jnp.float32(0.1))
    ref = {"loss": float(loss), "fg": int(aux["rpn_fg_sum"]),
           "grads": _flat(grads, "params"),
           "stats": _flat(new_bs, "batch_stats")}

    cfg = rpn_cfg(load_config, N_POINTS)
    model = build_model(cfg, device="cpu")
    load_flat(model, flat)
    named = dict(model.rpn.named_parameters(prefix="rpn"))
    tloss, taux, tgrads = rpn_gradients(
        model, cfg, batch_to_device(batch, "cpu"), None, 0.1, named)
    got = {"loss": float(tloss), "fg": int(taux["rpn_fg_sum"]),
           "grads": {npz_key(k): g.numpy() for k, g in tgrads.items()},
           "stats": {npz_key(k): v.numpy()
                     for k, v in model.state_dict().items()
                     if npz_key(k).startswith("batch_stats/")}}
    return ref, got


def test_loss_matches(step):
    ref, got = step
    assert got["fg"] == ref["fg"] > 0
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)


def test_every_gradient_matches(step):
    ref, got = step
    assert set(got["grads"]) == set(ref["grads"])
    for k, g in got["grads"].items():
        r = ref["grads"][k]
        scale = np.abs(r).max()
        assert scale > 0, k
        err = np.abs(g - r).max()
        assert err <= 1e-3 * scale, (k, err, scale)


def test_new_bn_statistics_match(step):
    ref, got = step
    assert set(got["stats"]) == set(ref["stats"])
    for k, v in got["stats"].items():
        np.testing.assert_allclose(v, ref["stats"][k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
