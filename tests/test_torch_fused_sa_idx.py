"""Kernel 9 (SA with given indices) on the CPU: the port's
fused_sa_single_scale runs its plain version forward and
sa_from_idx_backward backward. Value and gradient against the JAX XLA
composition fused_sa_pallas._xla_reference within 1e-5 (of each gradient's
largest magnitude), and against the
Pallas kernel in interpret mode within 2e-2 (value) and 5e-2 (gradient),
the precedent of tests/test_fused_sa.py: the TPU kernel gathers in bf16."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, random_mlp, sorted_cloud, t
from ws3d_tpu.ops.fused_sa_pallas import _xla_reference, fused_sa_single_scale
from ws3d_tpu.ops.grouping import ball_query
from ws3d_tpu_torch.ops import fused_sa_idx as tk

CASES = [  # (P, M, C, radius, S, widths)
    (128, 64, 8, 0.8, 16, [16, 16, 32]),
    (64, 32, 16, 1.5, 32, [32, 24, 48]),
    (256, 32, 3, 0.3, 8, [8, 8]),          # many empty and part-full balls
]


def _inputs(rng, P, M, C, radius, S, widths):
    xyz, feat = sorted_cloud(rng, 2, P, C, spread=1.0)
    new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))]
    idx = np.asarray(ball_query(radius, S, jnp.asarray(xyz),
                                jnp.asarray(new_xyz), force_xla=True))
    ks, bs = random_mlp(rng, 3 + C, widths)
    return xyz, feat, new_xyz, idx, ks, bs


def _jax_value_and_grads(fn, xyz, feat, new_xyz, ks, bs, g):
    def loss(x, f, q, k_, b_):
        return jnp.sum(fn(x, f, q, k_, b_) * g)
    args = (jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(new_xyz),
            tuple(map(jnp.asarray, ks)), tuple(map(jnp.asarray, bs)))
    out = fn(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return np.asarray(out), [np.asarray(a) for a in jax.tree.leaves(grads)]


def _port_value_and_grads(xyz, feat, new_xyz, idx, ks, bs, g):
    leaves = [t(a).requires_grad_(True) for a in (xyz, feat, new_xyz)]
    kt = [t(k).requires_grad_(True) for k in ks]
    bt = [t(b).requires_grad_(True) for b in bs]
    out = tk.fused_sa_single_scale(*leaves, t(idx), kt, bt)
    (out * t(g)).sum().backward()
    # jax.tree.leaves order: x, f, q, kernels..., biases...
    return n(out), [n(a.grad) for a in leaves + kt + bt]


@pytest.mark.parametrize("P,M,C,radius,S,widths", CASES)
def test_value_and_gradient_match_xla_reference(rng, P, M, C, radius, S,
                                                widths):
    xyz, feat, new_xyz, idx, ks, bs = _inputs(rng, P, M, C, radius, S,
                                              widths)
    g = rng.randn(2, M, widths[-1]).astype(np.float32)
    jidx = jnp.asarray(idx)
    ref, rgrads = _jax_value_and_grads(
        lambda x, f, q, k_, b_: _xla_reference(x, f, q, jidx, k_, b_),
        xyz, feat, new_xyz, ks, bs, g)
    got, ggrads = _port_value_and_grads(xyz, feat, new_xyz, idx, ks, bs, g)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert len(ggrads) == len(rgrads)
    for a, b in zip(ggrads, rgrads):
        # sums over up to B*M*S rows in another order: 1e-5 of the largest
        assert np.abs(b).max() > 0
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


@pytest.mark.parametrize("P,M,C,radius,S,widths", CASES[:2])
def test_value_and_gradient_match_pallas_interpret(rng, P, M, C, radius, S,
                                                   widths):
    xyz, feat, new_xyz, idx, ks, bs = _inputs(rng, P, M, C, radius, S,
                                              widths)
    g = rng.randn(2, M, widths[-1]).astype(np.float32)
    jidx = jnp.asarray(idx)
    ref, rgrads = _jax_value_and_grads(
        lambda x, f, q, k_, b_: fused_sa_single_scale(x, f, q, jidx, k_, b_,
                                                      interpret=True),
        xyz, feat, new_xyz, ks, bs, g)
    got, ggrads = _port_value_and_grads(xyz, feat, new_xyz, idx, ks, bs, g)
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    for a, b in zip(ggrads, rgrads):
        np.testing.assert_allclose(a, b, atol=5e-2, rtol=5e-2)


def test_backward_differentiates_only_what_requires_grad(rng):
    xyz, feat, new_xyz, idx, ks, bs = _inputs(rng, *CASES[0])
    f = t(feat).requires_grad_(True)
    kt = [t(k) for k in ks]
    bt = [t(b).requires_grad_(True) for b in bs]
    out = tk.fused_sa_single_scale(t(xyz), f, t(new_xyz), t(idx), kt, bt)
    assert out.grad_fn is not None
    out.sum().backward()
    assert f.grad is not None and all(b.grad is not None for b in bt)
    ref = tk.fused_sa_idx_plain(t(idx), t(xyz), t(feat), t(new_xyz), kt,
                                [t(b) for b in bs])
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    xyz, feat, new_xyz, idx, ks, bs = _inputs(rng, *CASES[0])
    with pytest.raises(ValueError, match="CUDA"):
        tk.fused_sa_idx_cuda(t(xyz), t(feat), t(new_xyz), t(idx),
                             [t(k) for k in ks], [t(b) for b in bs])
