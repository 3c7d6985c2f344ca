"""Kernel 4 (3-NN interpolation): the port's plain version against the JAX
XLA composition (_interpolate_xla(force_xla_nn=True); indices exact, floats
atol 1e-4) and the Pallas kernel in interpret mode (2e-2: it multiplies in
bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from ws3d_tpu.ops.interpolate import _interpolate_xla, _three_nn_chunk
from ws3d_tpu.ops.three_nn_pallas import three_interpolate_pallas
from ws3d_tpu_torch.ops.interpolate import (interpolate_features, three_nn,
                                            three_interpolate_plain)


@pytest.mark.parametrize("n_u,m,C", [(256, 64, 16), (512, 128, 32),
                                     (96, 2, 8), (40, 1, 4)])
def test_interpolate_matches_xla(rng, n_u, m, C):
    unknown = rng.randn(2, n_u, 3).astype(np.float32) * 2
    known = rng.randn(2, m, 3).astype(np.float32) * 2
    feats = rng.randn(2, m, C).astype(np.float32)
    d2, idx = _three_nn_chunk(jnp.asarray(unknown), jnp.asarray(known))
    got_d2, got_idx = three_nn(t(unknown), t(known))
    np.testing.assert_array_equal(n(got_idx), np.asarray(idx))
    np.testing.assert_array_equal(n(got_d2), np.asarray(d2))
    ref = _interpolate_xla(jnp.asarray(unknown), jnp.asarray(known),
                           jnp.asarray(feats), force_xla_nn=True)
    got = interpolate_features(t(unknown), t(known), t(feats))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-4, rtol=1e-5)


def test_three_nn_ties_take_the_lowest_index(rng):
    known = np.zeros((1, 16, 3), np.float32)
    known[0, :, 0] = np.repeat(np.arange(4.0), 4)       # 4 copies each
    unknown = np.array([[[0.2, 0.0, 0.0], [2.6, 0.0, 0.0]]], np.float32)
    _, idx = _three_nn_chunk(jnp.asarray(unknown), jnp.asarray(known))
    got = n(three_nn(t(unknown), t(known))[1])
    np.testing.assert_array_equal(got, np.asarray(idx))
    assert got[0, 0].tolist() == [0, 1, 2]


def test_interpolate_plain_chunks_agree(rng):
    unknown = rng.randn(1, 300, 3).astype(np.float32)
    known = rng.randn(1, 50, 3).astype(np.float32)
    feats = rng.randn(1, 50, 6).astype(np.float32)
    whole = three_interpolate_plain(t(unknown), t(known), t(feats))
    parts = three_interpolate_plain(t(unknown), t(known), t(feats), chunk=64)
    np.testing.assert_array_equal(n(whole), n(parts))


@pytest.mark.parametrize("n_u,m,C", [(256, 128, 32), (128, 256, 16)])
def test_interpolate_matches_pallas_interpret(rng, n_u, m, C):
    unknown = rng.randn(2, n_u, 3).astype(np.float32)
    known = rng.randn(2, m, 3).astype(np.float32)
    feats = rng.randn(2, m, C).astype(np.float32)
    ref = three_interpolate_pallas(jnp.asarray(unknown), jnp.asarray(known),
                                   jnp.asarray(feats), interpret=True)
    got = interpolate_features(t(unknown), t(known), t(feats))
    np.testing.assert_allclose(n(got), np.asarray(ref), atol=2e-2, rtol=2e-2)
