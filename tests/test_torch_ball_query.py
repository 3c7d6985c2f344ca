"""Kernel 6 (multi-scale ball query): the port's plain version against the
Pallas kernel in interpret mode and the JAX XLA path
(grouping.ball_query_multi), indices exact, at the shapes of
tests/test_ball_query_pallas.py, the backbone's radii, and empty, sparse
and boundary balls."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu.ops.ball_query_pallas import ball_query_pallas
from ws3d_tpu.ops.grouping import ball_query_multi as jax_ball_query_multi
from ws3d_tpu_torch.ops.ball_query import (ball_query_multi_cuda,
                                           ball_query_multi_plain)
from ws3d_tpu_torch.ops.grouping import ball_query_multi


def _assert_same(radii, ks, xyz, new_xyz, pallas=True):
    got = ball_query_multi(radii, ks, t(xyz), t(new_xyz))
    refs = [jax_ball_query_multi(radii, ks, jnp.asarray(xyz),
                                 jnp.asarray(new_xyz))]
    if pallas:
        refs.append(ball_query_pallas(radii, ks, jnp.asarray(xyz),
                                      jnp.asarray(new_xyz), interpret=True))
    assert len(got) == len(radii)
    for ref in refs:
        for g, r, k in zip(got, ref, ks):
            assert g.dtype == torch.int32 and g.shape[-1] == k
            np.testing.assert_array_equal(n(g), np.asarray(r))
    return got


@pytest.mark.parametrize("n_pts,m,radii,ks", [
    (512, 64, [0.5, 1.5], [8, 16]),
    (256, 32, [1.0], [4]),
    (128, 16, [0.2, 0.8], [2, 4]),
    (1024, 256, [0.1, 0.5], [16, 32]),        # backbone SA-1 radii
    (1024, 64, [2.0, 4.0], [16, 32]),         # backbone SA-4 radii
])
def test_matches_pallas_and_xla(rng, n_pts, m, radii, ks):
    xyz = rng.randn(2, n_pts, 3).astype(np.float32) * 3
    new_xyz = rng.randn(2, m, 3).astype(np.float32) * 3
    _assert_same(radii, ks, xyz, new_xyz)


def test_empty_and_sparse_balls(rng):
    # centres far from every point -> all zeros; sparse -> pad with first
    xyz = rng.randn(1, 128, 3).astype(np.float32) * 0.1
    new_xyz = np.array([[[50.0, 50, 50], [0, 0, 0]] * 4], np.float32)
    got = _assert_same([0.05, 0.5], [8, 16], xyz, new_xyz)
    assert (n(got[0])[0, 0] == 0).all() and (n(got[1])[0, 0] == 0).all()
    first = n(got[0])[0, 1]
    cnt = int(np.sum(np.sum((xyz[0] - new_xyz[0, 1]) ** 2, -1) < 0.05 ** 2))
    assert 0 < cnt < 8
    assert (first[cnt:] == first[0]).all()


def test_radius_boundary_is_strict_and_f32():
    """Points at d2 == r2 (f32) are out; r2 is the f32 rounding of the
    double product, not r*r in f32."""
    r = 0.1
    r2 = np.float32(r * r)
    offs = np.sqrt(np.array([r2, np.nextafter(r2, 0, dtype=np.float32),
                             np.nextafter(r2, 1, dtype=np.float32)],
                            np.float64))
    xyz = np.zeros((1, 128, 3), np.float32)
    xyz[0, :, 0] = 5.0
    xyz[0, 1:4, 0] = offs.astype(np.float32)
    new_xyz = np.zeros((1, 8, 3), np.float32)
    _assert_same([r], [4], xyz, new_xyz)


def test_chunks_share_one_distance_block(rng):
    xyz = torch.from_numpy(rng.randn(2, 300, 3).astype(np.float32))
    new_xyz = torch.from_numpy(rng.randn(2, 70, 3).astype(np.float32))
    a = ball_query_multi_plain([0.7, 1.4], [5, 9], xyz, new_xyz, chunk=16)
    b = ball_query_multi_plain([0.7, 1.4], [5, 9], xyz, new_xyz)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_cuda_wrapper_checks_its_arguments():
    x = torch.zeros(1, 128, 3)
    with pytest.raises(ValueError):
        ball_query_multi_cuda([0.5], [8], x, x[:, :8])          # CPU tensor
    with pytest.raises(ValueError):
        ball_query_multi_cuda([0.1] * 5, [4] * 5, x, x)         # > 4 scales
    with pytest.raises(ValueError):
        ball_query_multi_cuda([0.1], [0], x, x)
