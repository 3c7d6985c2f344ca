"""Which bf16 mode the BN-free SA stacks (the RCNN trunk's and the IOUN
cascade's) take at eval: the port's stage-2 eval outputs in both modes of
the fused SA against the JAX package's XLA bf16 eval, with the harness of
tests/test_torch_bf16_models.py (full widths, the fitted npz, crops of the
JAX package's f32 proposals on 2 scenes of 2,048 points).

- the bf16 mode (kBF16: bf16 factors, f32 sums, f32 bias and layers);
- the rounded-layer mode (kBF16Layers: each layer rounded to bf16 as
  flax's Dense(dtype=bfloat16) rounds it, the bias added in bf16), which
  the BN-free stacks' train forward takes since it was added.

Measured: the rounded-layer mode within 3.1e-7 of each output's f32 range
(max |diff| / max |f32|), the bf16 mode 1.3e-4 to 7.1e-3 away. So the
stacks' eval takes the rounded-layer mode (models/pointnet2.py), and the
default is held to it bit for bit. Tolerances: either mode within the
harness's 1e-2; the rounded-layer mode within 1e-6 (f32 sums in another
order can flip a bf16 rounding) and no farther than the bf16 mode on any
output."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ws3d_tpu_torch.models.pointnet2 as tp2
from test_torch_bf16_models import N, _apply, _jax, _port
from torch_port_helpers import n, synthetic_batch, t
from ws3d_tpu.pipeline.inference import crop_for_rcnn_batched, rpn_propose

KEYS = ("rcnn_cls", "rcnn_reg", "pred_boxes3d", "rcnn_iou", "ioun_cls",
        "rcnn_ref", "refined_box")
MODES = ("bf16", "bf16_layers", "default")


def _stage2(model, casc_boxes, crops):
    tc = {k: t(v) for k, v in crops.items()}
    with torch.no_grad():
        out = {k: n(v) for k, v in model.rcnn_trunk_forward(tc).items()}
        out.update({k: n(v) for k, v in model.ioun_forward(
            dict(tc, pred_boxes3d=t(casc_boxes))).items()
            if k != "pred_boxes3d"})
    return out


@pytest.fixture(scope="module")
def outputs():
    pts = synthetic_batch(2, N)
    jf, vf, cfg = _jax("float32")
    jb, vb, _ = _jax("bfloat16")
    f32_rpn = _apply(jf, vf, "rpn_forward", {"pts_input": jnp.asarray(pts)})
    centers = jax.vmap(lambda c, r, x: rpn_propose(
        c, r, x, cfg.RPN.LOC_SCOPE, cfg.RPN.LOC_BIN_SIZE,
        score_thresh=cfg.RPN.SCORE_THRESH, max_proposals=8)[0])(
        f32_rpn["rpn_cls"], f32_rpn["rpn_reg"], f32_rpn["backbone_xyz"])
    cr, _ = crop_for_rcnn_batched(jnp.asarray(pts),
                                  jax.nn.sigmoid(f32_rpn["rpn_cls"][..., 0]),
                                  centers, num_sampled=512)
    crops = {k: np.asarray(v).reshape((-1,) + v.shape[2:])
             for k, v in cr.items()}
    jc = {k: jnp.asarray(v) for k, v in crops.items()}
    # the cascade runs from the f32 trunk's boxes on every side
    f32 = {k: np.asarray(v) for k, v in _apply(
        jf, vf, "rcnn_trunk_forward", jc).items()}
    boxes = f32["pred_boxes3d"]
    casc = dict(jc, pred_boxes3d=jnp.asarray(boxes))
    f32.update({k: np.asarray(v) for k, v in _apply(
        jf, vf, "ioun_forward", casc).items() if k != "pred_boxes3d"})
    xla = {k: np.asarray(v) for k, v in _apply(
        jb, vb, "rcnn_trunk_forward", jc).items()}
    xla.update({k: np.asarray(v) for k, v in _apply(
        jb, vb, "ioun_forward", casc).items() if k != "pred_boxes3d"})
    port = _port("bfloat16")
    got = {"default": _stage2(port, boxes, crops)}
    fused_sa = tp2.fused_sa
    for mode, rounded in (("bf16", False), ("bf16_layers", True)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tp2, "fused_sa", lambda *a, _r=rounded, **kw: fused_sa(
                *a, **{**kw, "round_layers": _r and kw["bf16"]}))
            got[mode] = _stage2(port, boxes, crops)
    return {"f32": f32, "xla": xla, **got}


def _gap(outputs, mode, key) -> float:
    """max |port - JAX's XLA bf16| over max |JAX f32|."""
    scale = float(np.abs(outputs["f32"][key]).max())
    assert scale > 0
    return float(np.abs(outputs[mode][key] - outputs["xla"][key]).max()) \
        / scale


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("mode", MODES)
def test_stage2_eval_mode_matches_jax(outputs, mode, key):
    got = outputs[mode][key]
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _gap(outputs, mode, key) <= 1e-2
    assert float(np.abs(got - outputs["f32"][key]).max()) > 0   # bf16 rounds


@pytest.mark.parametrize("key", KEYS)
def test_rounded_layer_mode_is_closer_to_jax(outputs, key):
    rounded, other = (_gap(outputs, m, key) for m in ("bf16_layers", "bf16"))
    print(f"{key}: rounded-layer mode {rounded:.3g}, bf16 mode {other:.3g}")
    assert rounded <= 1e-6, rounded
    assert rounded <= other


def test_eval_takes_the_rounded_layer_mode(outputs):
    for key in KEYS:
        np.testing.assert_array_equal(outputs["default"][key],
                                      outputs["bf16_layers"][key])
    assert any(not np.array_equal(outputs["bf16"][k], outputs["default"][k])
               for k in KEYS)
