"""The fused SA's backward (FusedSA, kernels 2 and 3) on the CPU, where its
forward is the plain version and its backward takes the plain ball query's
indices: gradients against jax.grad through the JAX custom VJPs of
fused_sa_window and fused_sa_ballquery (Pallas forwards in interpret mode)
and through the XLA composition. The loss is linear in the output, so the
cotangent entering either VJP is exact and the JAX backward is the f32 XLA
VJP: 1e-5 of each gradient's largest magnitude (sums in another order), no
bf16 tolerance needed. Also: the SA module sends BN-free train stages
through FusedSA and BN stages through the unfused path, and FusedSA keeps
only its inputs for the backward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, random_mlp, sorted_cloud, t
from ws3d_tpu.ops.fused_sa_bq_pallas import _xla_reference, fused_sa_ballquery
from ws3d_tpu.ops.fused_sa_window_pallas import fused_sa_window
from ws3d_tpu_torch.models import pointnet2
from ws3d_tpu_torch.ops.fused_sa import fused_sa_plain, fused_sa_train

CASES = [  # (P, M, C, radius, S, widths)
    (128, 32, 8, 0.8, 16, [16, 16, 32]),
    (256, 64, 4, 0.5, 8, [8, 16]),
]


def _inputs(rng, P, M, C, radius, S, widths):
    xyz, feat = sorted_cloud(rng, 2, P, C, spread=1.0)
    new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))]
    ks, bs = random_mlp(rng, 3 + C, widths)
    g = rng.randn(2, M, widths[-1]).astype(np.float32)
    return xyz, feat, new_xyz, ks, bs, g


def _jax_grads(fn, xyz, feat, new_xyz, ks, bs, g):
    def loss(x, f, q, k_, b_):
        return jnp.sum(fn(x, f, q, k_, b_) * g)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(new_xyz),
        tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, bs)))
    return [np.asarray(a) for a in jax.tree.leaves(grads)]


def _port_grads(xyz, feat, new_xyz, ks, bs, g, radius, S, window):
    leaves = [t(a).requires_grad_(True) for a in (xyz, feat, new_xyz)]
    kt = [t(k).requires_grad_(True) for k in ks]
    bt = [t(b).requires_grad_(True) for b in bs]
    out = fused_sa_train(*leaves, radius, S, kt, bt, window)
    (out * t(g)).sum().backward()
    return [n(a.grad) for a in leaves + kt + bt]


def _assert_close(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.abs(b).max() > 0
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("P,M,C,radius,S,widths", CASES)
def test_gradients_match_the_jax_custom_vjps(rng, P, M, C, radius, S, widths,
                                             window):
    xyz, feat, new_xyz, ks, bs, g = _inputs(rng, P, M, C, radius, S, widths)
    kern = fused_sa_window if window else fused_sa_ballquery
    ref = _jax_grads(lambda x, f, q, k_, b_: kern(x, f, q, radius, S, k_, b_,
                                                  interpret=True),
                     xyz, feat, new_xyz, ks, bs, g)
    _assert_close(_port_grads(xyz, feat, new_xyz, ks, bs, g, radius, S,
                              window), ref)


@pytest.mark.parametrize("P,M,C,radius,S,widths", CASES)
def test_gradients_match_the_xla_composition(rng, P, M, C, radius, S, widths):
    xyz, feat, new_xyz, ks, bs, g = _inputs(rng, P, M, C, radius, S, widths)
    ref = _jax_grads(lambda x, f, q, k_, b_: _xla_reference(
        x, f, q, radius, S, k_, b_), xyz, feat, new_xyz, ks, bs, g)
    _assert_close(_port_grads(xyz, feat, new_xyz, ks, bs, g, radius, S,
                              False), ref)


def test_saves_only_inputs_and_weights(rng):
    xyz, feat, new_xyz, ks, bs, _ = _inputs(rng, *CASES[0])
    f = t(feat).requires_grad_(True)
    kt = [t(k).requires_grad_(True) for k in ks]
    bt = [t(b).requires_grad_(True) for b in bs]
    out = fused_sa_train(t(xyz), f, t(new_xyz), 0.8, 16, kt, bt, True)
    saved = out.grad_fn.saved_tensors
    assert [tuple(s.shape) for s in saved] == [
        tuple(a.shape) for a in [t(xyz), f, t(new_xyz)] + kt + bt]
    ref = fused_sa_plain(t(xyz), t(feat), t(new_xyz), 0.8, 16,
                         [t(k) for k in ks], [t(b) for b in bs])
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)


@pytest.mark.parametrize("use_bn", [False, True])
def test_train_dispatch(rng, monkeypatch, use_bn):
    calls = []
    orig = pointnet2.fused_sa_train

    def counting(*a, **kw):
        calls.append(a[3])
        return orig(*a, **kw)
    monkeypatch.setattr(pointnet2, "fused_sa_train", counting)
    sa = pointnet2.PointnetSAModuleMSG(32, [0.4, 0.8], [8, 16],
                                       [[16, 16], [16, 32]], cin=4,
                                       use_bn=use_bn, sorted_points=True)
    for p in sa.parameters():
        torch.nn.init.normal_(p, std=0.3)
    xyz, feat = sorted_cloud(rng, 2, 128, 4, spread=1.0)
    f = t(feat).requires_grad_(True)
    new_xyz, out = sa(t(xyz), f, train=True)
    out.sum().backward()
    assert f.grad is not None and f.grad.abs().max() > 0
    assert calls == ([] if use_bn else [0.4, 0.8])
    if not use_bn:        # the same function as eval for a BN-free stage
        with torch.no_grad():
            _, ref = sa(t(xyz), t(feat))
        torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    group_all = pointnet2.PointnetSAModuleMSG(None, [1.0], [16], [[8]],
                                              cin=4, use_bn=False)
    group_all(t(xyz), t(feat), train=True)
    assert len(calls) == (0 if use_bn else 2)     # GroupAll stays plain
