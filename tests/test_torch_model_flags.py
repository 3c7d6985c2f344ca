"""Two model flags off the shipped path, against the JAX package on the CPU:
cfg.ATTENTION=True (the context-attention residual before every SA stage
of the trunk and the cascade) on the stage-2 forward with the fitted trunk
and a seeded cascade, and RPN.USE_INTENSITY=False (3-channel input: SA0's
layer 0 has 3 input rows, no fused kernel) on the stage-1 forward with a
seeded JAX init carried across by weights.load_variables. Outputs within
1e-4 of the largest magnitude (f32 sums in another order).
RCNN.ROI_SAMPLE_JIT=False stays refused by both packages."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict, unflatten_dict

from torch_port_helpers import (n, rpn_cfg, stage2_batch, stage2_cfg,
                                stage2_flat_weights, synthetic_batch, t)
from ws3d_tpu.config import load_config as jax_load_config
from ws3d_tpu.models import build_model as jax_build, init_model
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.models.rcnn import context_attention
from ws3d_tpu_torch.weights import flat_variables, load_flat, load_variables

RTOL = 1e-4


def _close(got, ref, what):
    scale = max(float(np.abs(ref).max()), 1.0)
    err = float(np.abs(got - ref).max())
    assert err <= RTOL * scale, (what, err, scale)


def test_context_attention_matches_jax(rng):
    from ws3d_tpu.models.rcnn import context_attention as jax_attention
    f = rng.randn(3, 64, 16).astype(np.float32)
    ref = np.asarray(jax_attention(jnp.asarray(f)))
    _close(n(context_attention(t(f))), ref, "attention")


@pytest.fixture(scope="module")
def stage2_attention():
    jcfg = stage2_cfg(jax_load_config, "ioun")
    tcfg = stage2_cfg(load_config, "ioun")
    for cfg in (jcfg, tcfg):
        cfg.ATTENTION = True
    flat = stage2_flat_weights(True)
    jmodel = jax_build(jcfg)
    variables = init_model(jmodel, jcfg, jax.random.PRNGKey(0))
    f = flatten_dict(jax.tree.map(np.asarray, variables["params"]))
    params = unflatten_dict({k: flat["params/" + "/".join(k)] for k in f})
    batch = stage2_batch("ioun", n_crops=4)
    crops = {k: batch[k] for k in ("cur_box_point", "cur_box_reflect",
                                   "train_mask")}
    ref = jax.jit(lambda p, b: jmodel.apply(
        {"params": p}, b, train=False, method=jmodel.rcnn_forward))(
        params, {k: jnp.asarray(v) for k, v in crops.items()})
    model = build_model(tcfg, device="cpu")
    load_flat(model, flat)
    got = model.rcnn_forward({k: t(v) for k, v in crops.items()})
    off = copy.deepcopy(tcfg)
    off.ATTENTION = False
    plain = build_model(off, device="cpu")
    load_flat(plain, flat)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: n(v) for k, v in got.items()},
            {k: n(v) for k, v in plain.rcnn_forward(
                {k: t(v) for k, v in crops.items()}).items()})


@pytest.mark.parametrize("key", ["rcnn_cls", "rcnn_reg", "rcnn_iou",
                                 "refined_box"])
def test_attention_stage2_matches_jax(stage2_attention, key):
    ref, got, _ = stage2_attention
    _close(got[key], ref[key], key)


def test_attention_changes_the_forward(stage2_attention):
    _, got, plain = stage2_attention
    assert np.abs(got["rcnn_reg"] - plain["rcnn_reg"]).max() > 1e-3


@pytest.fixture(scope="module")
def stage1_no_intensity():
    jcfg, tcfg = rpn_cfg(jax_load_config), rpn_cfg(load_config)
    for cfg in (jcfg, tcfg):
        cfg.RPN.USE_INTENSITY = False
        cfg.RCNN.ENABLED = False
    jmodel = jax_build(jcfg)
    variables = init_model(jmodel, jcfg, jax.random.PRNGKey(3))
    pts = synthetic_batch(2, 2048)[..., :3]
    ref = jax.jit(lambda v, p: jmodel.apply(
        v, {"pts_input": p}, train=False, method=jmodel.rpn_forward))(
        variables, jnp.asarray(pts))
    model = build_model(tcfg, device="cpu")
    np_vars = jax.tree.map(np.asarray, variables)
    assert flat_variables(np_vars)[
        "params/rpn/backbone/sa_0/mlp_0/Dense_0/kernel"].shape[0] == 3
    assert load_variables(model, np_vars) == len(model.state_dict())
    got = model.rpn_forward({"pts_input": t(pts)})
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: n(v) for k, v in got.items()})


@pytest.mark.parametrize("key", ["rpn_cls", "rpn_reg", "backbone_features"])
def test_no_intensity_stage1_matches_jax(stage1_no_intensity, key):
    ref, got = stage1_no_intensity
    _close(got[key], ref[key], key)


def test_roi_sample_jit_false_is_refused_by_both():
    from ws3d_tpu.models.rcnn import rcnn_from_config
    for load, build in ((jax_load_config, rcnn_from_config),
                        (load_config,
                         lambda c: build_model(c, device="cpu"))):
        cfg = load()
        cfg.RCNN.ENABLED = True
        cfg.RCNN.ROI_SAMPLE_JIT = False
        with pytest.raises(NotImplementedError):
            build(cfg)
