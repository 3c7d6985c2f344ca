"""The stage-2 losses and the corner geometry against ws3d_tpu/losses.py on
the same random boxes and head outputs: values within 1e-5 relative, the
gradients reaching the heads within 1e-5 of their largest magnitude, the
bin branches of rcnn_reg_loss included, and the has_fg gates."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu import losses as jl
from ws3d_tpu.ops.boxes import boxes3d_to_corners3d as j_corners
from ws3d_tpu_torch import losses as tl
from ws3d_tpu_torch.ops.boxes import boxes3d_to_corners3d

ANCHOR = np.array([1.5, 1.6, 3.9], np.float32)


def _boxes(rng, P):
    b = np.zeros((P, 7), np.float32)
    b[:, [0, 2]] = rng.randn(P, 2) * 0.5
    b[:, 1] = 1.65 + rng.randn(P) * 0.1
    b[:, 3:6] = ANCHOR * (1 + rng.randn(P, 3) * 0.1)
    b[:, 6] = rng.uniform(-math.pi, math.pi, P)
    return b


def _case(rng, P=16):
    gt = _boxes(rng, P)
    pred = gt + rng.randn(P, 7).astype(np.float32) * 0.15
    cls = (rng.rand(P) < 0.6).astype(np.float32)
    gt = gt * cls[:, None]
    return {"reg": rng.randn(P, 52).astype(np.float32),
            "cls_logit": rng.randn(P).astype(np.float32),
            "pred": pred.astype(np.float32), "gt": gt, "cls": cls,
            "iou": rng.rand(P).astype(np.float32),
            "ref": rng.randn(P, 7).astype(np.float32) * 0.2}


def test_corners_match(rng):
    b = _boxes(rng, 20)
    np.testing.assert_allclose(n(boxes3d_to_corners3d(t(b))),
                               np.asarray(j_corners(jnp.asarray(b))),
                               atol=1e-6)


@pytest.mark.parametrize("fine", [(False, False, False), (True, True, True),
                                  (True, False, False)])
def test_rcnn_reg_loss_branches(rng, fine):
    c = _case(rng)
    c["reg"] = rng.randn(16, 64).astype(np.float32)   # room for the y bins
    xz, y, ry = fine
    kw = dict(get_xz_fine=xz, get_y_by_bin=y, get_ry_fine=ry)
    ref = jl.rcnn_reg_loss(jnp.asarray(c["reg"]), jnp.asarray(c["gt"]),
                           jnp.asarray(c["cls"] > 0), jnp.asarray(ANCHOR),
                           1.5, 0.5, 12, **kw)
    got = tl.rcnn_reg_loss(t(c["reg"]), t(c["gt"]), t(c["cls"] > 0),
                           t(ANCHOR), 1.5, 0.5, 12, **kw)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_diag_iou_and_corner_loss(rng):
    c = _case(rng, 24)
    ref = np.asarray(jl.pairwise_diag_iou3d(jnp.asarray(c["pred"]),
                                            jnp.asarray(c["gt"])))
    got = n(tl.pairwise_diag_iou3d(t(c["pred"]), t(c["gt"])))
    np.testing.assert_allclose(got, ref, atol=1e-5)
    mask = (c["cls"] > 0) & (ref > 0.5)
    assert mask.any()
    np.testing.assert_allclose(
        float(tl.corner_loss(t(c["pred"]), t(c["gt"]), t(mask))),
        float(jl.corner_loss(jnp.asarray(c["pred"]), jnp.asarray(c["gt"]),
                             jnp.asarray(mask))), rtol=1e-5)


def _grads_close(got, ref):
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert np.abs(n(a) - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-12)


@pytest.mark.parametrize("no_fg", [False, True])
def test_rcnn_loss_and_gradients(rng, no_fg):
    c = _case(rng)
    if no_fg:
        c["cls"][:] = 0
    def jloss(cls_logit, reg):
        return jl.rcnn_loss(cls_logit, reg, jnp.asarray(c["pred"]),
                            jnp.asarray(c["gt"]), jnp.asarray(c["cls"]),
                            jnp.asarray(ANCHOR))
    (rtot, raux), rg = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(c["cls_logit"]), jnp.asarray(c["reg"]))
    logit = t(c["cls_logit"]).requires_grad_(True)
    reg = t(c["reg"]).requires_grad_(True)
    tot, aux = tl.rcnn_loss(logit, reg, t(c["pred"]), t(c["gt"]),
                            t(c["cls"]), t(ANCHOR))
    tot.backward()
    aux = {k: float(v.detach()) for k, v in aux.items()}
    assert set(aux) == set(raux)
    for k in aux:
        np.testing.assert_allclose(aux[k], float(raux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if no_fg:
        assert aux["rcnn_loss_loc"] == 0 == aux["rcnn_loss_size"]
    _grads_close([logit.grad, reg.grad], rg)


@pytest.mark.parametrize("no_fg", [False, True])
def test_ioun_loss_and_gradients(rng, no_fg):
    c = _case(rng)
    if no_fg:
        c["cls"][:] = 0
    refined = c["pred"] + c["ref"]

    def jloss(iou, ref):
        return jl.ioun_loss(iou, ref, jnp.asarray(c["pred"]),
                            jnp.asarray(refined), jnp.asarray(c["gt"]),
                            jnp.asarray(c["cls"]))
    (rtot, raux), rg = jax.value_and_grad(jloss, argnums=(0, 1),
                                          has_aux=True)(
        jnp.asarray(c["iou"]), jnp.asarray(c["ref"]))
    iou = t(c["iou"]).requires_grad_(True)
    ref = t(c["ref"]).requires_grad_(True)
    tot, aux = tl.ioun_loss(iou, ref, t(c["pred"]), t(refined), t(c["gt"]),
                            t(c["cls"]))
    tot.backward()
    aux = {k: float(v.detach()) for k, v in aux.items()}
    assert set(aux) == set(raux)
    for k in aux:
        np.testing.assert_allclose(aux[k], float(raux[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if no_fg:
        assert aux["ioun_loss_loc"] == 0
    _grads_close([iou.grad, ref.grad], rg)
