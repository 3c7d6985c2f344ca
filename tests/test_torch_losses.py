"""Stage-1 losses against ws3d_tpu.losses on the same logits and labels
(within 1e-5 relative), their gradients, and the denormal-label case."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu import losses as jl
from ws3d_tpu_torch import losses as tl

KW = dict(loc_scope=4.0, loc_bin_size=0.8, focal_alpha=0.25,
          focal_gamma=2.0, loss_weights=(1.0, 1.0))


def _inputs(rng, B=2, N=1024, fg=True):
    cls = (rng.randn(B, N, 1) * 2).astype(np.float32)
    reg = rng.randn(B, N, 40).astype(np.float32)
    lab = np.clip(rng.rand(B, N) * 1.5 - 0.5, 0, 1).astype(np.float32)
    if not fg:
        lab[:] = 0
    rl = (rng.randn(B, N, 3) * 2.5).astype(np.float32)
    rl[..., 1] = 0
    return cls, reg, lab, rl


@pytest.mark.parametrize("fg", [True, False])
def test_rpn_loss_matches_jax(rng, fg):
    cls, reg, lab, rl = _inputs(rng, fg=fg)
    ref_total, ref_aux = jl.rpn_loss(*map(jnp.asarray, (cls, reg, lab, rl)),
                                     **KW)
    total, aux = tl.rpn_loss(*map(t, (cls, reg, lab, rl)), **KW)
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)
    for k, v in ref_aux.items():
        np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-5,
                                   atol=1e-7)


def test_rpn_loss_gradients_match_jax(rng):
    cls, reg, lab, rl = _inputs(rng)
    gc, gr = jax.grad(lambda c, r: jl.rpn_loss(
        c, r, jnp.asarray(lab), jnp.asarray(rl), **KW)[0], argnums=(0, 1))(
        jnp.asarray(cls), jnp.asarray(reg))
    c, r = t(cls).requires_grad_(True), t(reg).requires_grad_(True)
    tl.rpn_loss(c, r, t(lab), t(rl), **KW)[0].backward()
    for got, ref in ((c.grad, gc), (r.grad, gr)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(n(got), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


def test_denormal_labels_are_background(rng):
    """The Gaussian labels underflow to denormals far from every centre;
    XLA flushes them to zero, so they count as background there."""
    cls, reg, lab, rl = _inputs(rng)
    lab[:, ::3] = np.float32(1e-40)
    ref_total, ref_aux = jl.rpn_loss(*map(jnp.asarray, (cls, reg, lab, rl)),
                                     **KW)
    total, aux = tl.rpn_loss(*map(t, (cls, reg, lab, rl)), **KW)
    assert int(aux["rpn_fg_sum"]) == int(ref_aux["rpn_fg_sum"])
    np.testing.assert_allclose(float(total), float(ref_total), rtol=1e-5)


def test_elementwise_pieces(rng):
    x = (rng.randn(500) * 4).astype(np.float32)
    z = rng.rand(500).astype(np.float32)
    w = rng.rand(500).astype(np.float32)
    np.testing.assert_allclose(
        n(tl.sigmoid_focal_loss(t(x), t(z), t(w), 0.25, 2.0)),
        np.asarray(jl.sigmoid_focal_loss(jnp.asarray(x), jnp.asarray(z),
                                         jnp.asarray(w), 0.25, 2.0)),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        n(tl.smooth_l1(t(x), t(z))),
        np.asarray(jl.smooth_l1(jnp.asarray(x), jnp.asarray(z))), rtol=1e-6)
    labels = rng.randint(0, 10, size=50)
    logits = rng.randn(50, 10).astype(np.float32)
    np.testing.assert_allclose(
        n(tl.softmax_cross_entropy_int(t(logits), t(labels))),
        np.asarray(jl.softmax_cross_entropy_int(jnp.asarray(logits),
                                                jnp.asarray(labels))),
        rtol=1e-5)
    mask = rng.rand(50) > 0.5
    np.testing.assert_allclose(
        float(tl.masked_mean(t(logits), t(mask))),
        float(jl.masked_mean(jnp.asarray(logits), jnp.asarray(mask))),
        rtol=1e-5)
    assert float(tl.masked_mean(t(logits), t(np.zeros(50, bool)))) == 0.0
