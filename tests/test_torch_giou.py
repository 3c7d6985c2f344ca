"""The port's differentiable 3D IoU / GIoU (ws3d_tpu_torch.ops.giou)
against ws3d_tpu.ops.giou on the same aligned box pairs: values within
1e-5, gradients (plain autograd against jax.grad) within 1e-4 of the
largest magnitude of each plus 1e-6, on overlapping, disjoint and
identical pairs. (The 1e-6 floor is for identical pairs: there the GIoU's
gradient is rounding noise near 1e-7 in both packages.)"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu.ops import giou as jg
from ws3d_tpu_torch.ops import giou as tg

VAL_ATOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-6


def _pairs(rng, P, case):
    a = np.zeros((P, 7), np.float32)
    a[:, [0, 2]] = rng.randn(P, 2) * 2.0
    a[:, 1] = 1.65 + rng.randn(P) * 0.1
    a[:, 3:6] = np.array([1.5, 1.6, 3.9], np.float32) * (
        1 + rng.randn(P, 3) * 0.1)
    a[:, 6] = rng.uniform(-math.pi, math.pi, P)
    if case == "identical":
        return a, a.copy()
    b = a.copy()
    shift = 0.6 if case == "overlap" else 8.0
    b[:, [0, 2]] += rng.randn(P, 2) * shift
    b[:, 1] += rng.randn(P) * 0.2
    b[:, 3:6] *= 1 + rng.randn(P, 3) * 0.1
    b[:, 6] += rng.randn(P) * 0.3
    return a, b.astype(np.float32)


@pytest.mark.parametrize("case", ["overlap", "disjoint", "identical"])
def test_values(case):
    a, b = _pairs(np.random.RandomState(1), 64, case)
    ref_iou, _ = jg.paired_iou3d(jnp.asarray(a), jnp.asarray(b))
    got_iou, _ = tg.paired_iou3d(t(a), t(b))
    np.testing.assert_allclose(n(got_iou), np.asarray(ref_iou),
                               atol=VAL_ATOL)
    ref = jg.paired_giou3d(jnp.asarray(a), jnp.asarray(b))
    got = tg.paired_giou3d(t(a), t(b))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=VAL_ATOL)
    if case == "overlap":
        assert (np.asarray(ref_iou) > 0.05).sum() > 32
    elif case == "disjoint":
        assert (np.asarray(ref) < 0).sum() > 32
    else:
        np.testing.assert_allclose(n(got_iou), 1.0, atol=VAL_ATOL)
    # hull of 8 points (incl. interior ones) by itself
    pts = np.random.RandomState(2).randn(16, 8, 2).astype(np.float32)
    np.testing.assert_allclose(
        n(tg._hull_area_8(t(pts))),
        np.asarray(jg._hull_area_8(jnp.asarray(pts))), atol=VAL_ATOL)


@pytest.mark.parametrize("case", ["overlap", "identical"])
@pytest.mark.parametrize("loss", ["ious_3d_loss", "gious_3d_loss"])
def test_gradients(case, loss):
    gt, pred = _pairs(np.random.RandomState(3), 48, case)
    ref_v, ref_g = jax.value_and_grad(getattr(jg, loss), argnums=(0, 1))(
        jnp.asarray(gt), jnp.asarray(pred))
    tgt = t(gt).requires_grad_(True)
    tpred = t(pred).requires_grad_(True)
    val = getattr(tg, loss)(tgt, tpred)
    grads = torch.autograd.grad(val, (tgt, tpred))
    assert abs(val.item() - float(ref_v)) <= VAL_ATOL
    for g, r in zip(grads, ref_g):
        r = np.asarray(r)
        scale = np.abs(r).max()
        err = np.abs(n(g) - r).max()
        assert err <= GRAD_TOL * scale + GRAD_FLOOR, (err, scale)
        if case == "overlap":
            assert scale > 1e-3
