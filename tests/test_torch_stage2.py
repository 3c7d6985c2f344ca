"""Stage 2 at full widths with the fitted npz: identical crops go into the
RCNN trunk and the IOUN cascade of both packages. The crops come from the
JAX package's own crop step on a synthetic scene, so both networks see the
same points in the same order; outputs differ only by f32 summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_detector, n, synthetic_batch, t, \
    torch_detector
from ws3d_tpu.pipeline.inference import crop_for_rcnn_batched, rpn_propose

ATOL = 1e-3           # f32 through ~10 dense layers, another summation order
RTOL = 1e-4


@pytest.fixture(scope="module")
def crops():
    pts = synthetic_batch(2, 4096)
    jmodel, variables, cfg = jax_detector()
    rpn = jax.jit(lambda v, p: jmodel.apply(
        v, {"pts_input": p}, train=False, method=jmodel.rpn_forward))(
        variables, jnp.asarray(pts))
    centers = jax.vmap(lambda c, r, x: rpn_propose(
        c, r, x, cfg.RPN.LOC_SCOPE, cfg.RPN.LOC_BIN_SIZE,
        score_thresh=cfg.RPN.SCORE_THRESH, max_proposals=8)[0])(
        rpn["rpn_cls"], rpn["rpn_reg"], rpn["backbone_xyz"])
    cr, _ = crop_for_rcnn_batched(jnp.asarray(pts),
                                  jax.nn.sigmoid(rpn["rpn_cls"][..., 0]),
                                  centers, num_sampled=512)
    return {k: np.asarray(v).reshape((-1,) + v.shape[2:])
            for k, v in cr.items()}


def test_trunk_and_cascade_match(crops):
    jmodel, variables, _ = jax_detector()
    tmodel, _ = torch_detector()
    jc = {k: jnp.asarray(v) for k, v in crops.items()}
    ref = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, method=jmodel.rcnn_trunk_forward))(variables, jc)
    with torch.no_grad():
        got = tmodel.rcnn_trunk_forward({k: t(v) for k, v in crops.items()})
    for key in ("rcnn_cls", "rcnn_reg", "pred_boxes3d"):
        np.testing.assert_allclose(n(got[key]), np.asarray(ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)

    boxes = np.asarray(ref["pred_boxes3d"])
    casc_ref = jax.jit(lambda v, b: jmodel.apply(
        v, b, train=False, method=jmodel.ioun_forward))(
        variables, dict(jc, pred_boxes3d=jnp.asarray(boxes)))
    with torch.no_grad():
        casc = tmodel.ioun_forward(dict({k: t(v) for k, v in crops.items()},
                                        pred_boxes3d=t(boxes)))
    for key in ("rcnn_iou", "ioun_cls", "rcnn_ref", "refined_box"):
        np.testing.assert_allclose(n(casc[key]), np.asarray(casc_ref[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)
