"""Stage 1 at full widths with the fitted npz on a small cloud (N = 4096,
NPOINTS [1024, 256, 64, 16]): the port's RPN against model.rpn_forward, and
the proposals. The two differ only in float summation order (the port folds
BN into the SA/FP weights), so outputs agree to ~1e-5 and every index-valued
result (FPS picks, ball-query slots, proposals) is identical."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_detector, n, synthetic_batch, t, \
    torch_detector
from ws3d_tpu.pipeline.inference import rpn_propose as jax_propose
from ws3d_tpu_torch.pipeline.inference import rpn_propose

ATOL = 2e-4           # f32, values O(1-10), different summation order
RTOL = 1e-4


@pytest.fixture(scope="module")
def outputs():
    pts = synthetic_batch(2, 4096)
    jmodel, variables, cfg = jax_detector()
    ref = jax.jit(lambda v, p: jmodel.apply(
        v, {"pts_input": p}, train=False, method=jmodel.rpn_forward))(
        variables, jnp.asarray(pts))
    tmodel, _ = torch_detector()
    with torch.no_grad():
        got = tmodel.rpn_forward({"pts_input": t(pts)})
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: n(v) for k, v in got.items()}, cfg


@pytest.mark.parametrize("key", ["rpn_cls", "rpn_reg", "backbone_xyz",
                                 "backbone_features"])
def test_rpn_outputs_match(outputs, key):
    ref, got, _ = outputs
    assert got[key].shape == ref[key].shape
    np.testing.assert_allclose(got[key], ref[key], atol=ATOL, rtol=RTOL)


def test_proposals_match(outputs):
    ref, got, cfg = outputs
    kw = dict(loc_scope=cfg.RPN.LOC_SCOPE, loc_bin_size=cfg.RPN.LOC_BIN_SIZE,
              score_thresh=cfg.RPN.SCORE_THRESH, pre_nms_top=512,
              max_proposals=64)
    # both sides propose from the same (JAX) RPN outputs: exact semantics
    c, s, v = rpn_propose(t(ref["rpn_cls"]), t(ref["rpn_reg"]),
                          t(ref["backbone_xyz"]), **kw)
    for i in range(2):
        rc, rs, rv = jax_propose(ref["rpn_cls"][i], ref["rpn_reg"][i],
                                 ref["backbone_xyz"][i], **kw)
        np.testing.assert_array_equal(n(v[i]), np.asarray(rv))
        np.testing.assert_array_equal(n(c[i]), np.asarray(rc))
        np.testing.assert_array_equal(n(s[i]), np.asarray(rs))
    assert n(v).sum() > 0
    # and from the port's own RPN outputs: the same valid masks and centres
    c2, _, v2 = rpn_propose(t(got["rpn_cls"]), t(got["rpn_reg"]),
                            t(got["backbone_xyz"]), **kw)
    np.testing.assert_array_equal(n(v2), n(v))
    np.testing.assert_allclose(n(c2), n(c), atol=1e-4)
