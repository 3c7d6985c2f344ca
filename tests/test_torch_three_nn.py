"""Kernel 7 (3-NN search) and the interpolation's backward: the port's plain
3-NN against the Pallas kernel in interpret mode and the JAX XLA search
(_three_nn_chunk), indices exact, d2 within 1e-6 relative, m < 3 and ties
included; the gradient of interpolate_features in the known features
against JAX's VJP of the XLA interpolation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu.ops.interpolate import _interpolate_xla, _three_nn_chunk
from ws3d_tpu.ops.three_nn_pallas import three_nn_pallas
from ws3d_tpu_torch.ops.interpolate import (interpolate_features,
                                            three_interpolate_plain,
                                            three_nn, three_nn_cuda,
                                            three_nn_plain)


def _check(unknown, known, pallas):
    d2, idx = three_nn(t(unknown), t(known))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    refs = [_three_nn_chunk(jnp.asarray(unknown), jnp.asarray(known))]
    if pallas:
        refs.append(three_nn_pallas(jnp.asarray(unknown), jnp.asarray(known),
                                    interpret=True))
    for rd2, ridx in refs:
        np.testing.assert_array_equal(n(idx), np.asarray(ridx))
        np.testing.assert_allclose(n(d2), np.asarray(rd2), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("n_u,m", [(256, 128), (512, 256), (64, 512)])
def test_matches_pallas_and_xla(rng, n_u, m):
    _check(rng.randn(2, n_u, 3).astype(np.float32) * 2,
           rng.randn(2, m, 3).astype(np.float32) * 2, pallas=True)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_fewer_than_three_known(rng, m):
    _check(rng.randn(2, 40, 3).astype(np.float32),
           rng.randn(2, m, 3).astype(np.float32), pallas=False)


def test_ties_take_the_lowest_index(rng):
    known = rng.randn(2, 128, 3).astype(np.float32)
    known[:, 5] = known[:, 2]
    known[:, 9] = known[:, 2]
    known[:, 70] = known[:, 40]
    unknown = np.concatenate([known[:, [2, 40]],
                              rng.randn(2, 62, 3).astype(np.float32)], 1)
    _check(unknown, known, pallas=True)
    idx = n(three_nn(t(unknown), t(known))[1])
    assert (idx[:, 0] == [2, 5, 9]).all()


def test_plain_chunks(rng):
    u = torch.from_numpy(rng.randn(2, 300, 3).astype(np.float32))
    k = torch.from_numpy(rng.randn(2, 50, 3).astype(np.float32))
    a, b = three_nn_plain(u, k, chunk=64), three_nn_plain(u, k)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n_u,m,C", [(512, 128, 32), (96, 2, 8)])
def test_backward_matches_jax_vjp(rng, n_u, m, C):
    unknown = rng.randn(2, n_u, 3).astype(np.float32) * 2
    known = rng.randn(2, m, 3).astype(np.float32) * 2
    feats = rng.randn(2, m, C).astype(np.float32)
    g = rng.randn(2, n_u, C).astype(np.float32)
    _, vjp = jax.vjp(lambda f: _interpolate_xla(
        jnp.asarray(unknown), jnp.asarray(known), f, force_xla_nn=True),
        jnp.asarray(feats))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    f = t(feats).requires_grad_(True)
    (interpolate_features(t(unknown), t(known), f) * t(g)).sum().backward()
    np.testing.assert_allclose(n(f.grad), ref, atol=1e-5, rtol=1e-5)
    # and autograd through the plain forward
    f2 = t(feats).requires_grad_(True)
    (three_interpolate_plain(t(unknown), t(known), f2)
     * t(g)).sum().backward()
    np.testing.assert_allclose(n(f.grad), n(f2.grad), atol=1e-5, rtol=1e-5)


def test_coordinates_get_no_gradient(rng):
    u = t(rng.randn(1, 16, 3).astype(np.float32))
    k = t(rng.randn(1, 8, 3).astype(np.float32))
    f = t(rng.randn(1, 8, 4).astype(np.float32))
    with pytest.raises(ValueError, match="coordinates"):
        interpolate_features(u.requires_grad_(True), k, f)
    with pytest.raises(ValueError):
        three_nn_cuda(k, k)                                 # CPU tensor
