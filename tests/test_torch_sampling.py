"""Kernel 1 (FPS): the port's plain version against the JAX scan and the
Pallas kernel in interpret mode. Indices must match exactly; the picked
coordinates are gathered, so they match exactly too."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from ws3d_tpu.ops.sampling import _fps_pallas, _fps_scan
from ws3d_tpu_torch.ops.sampling import (fps_plain,
                                         furthest_point_sample_with_coords,
                                         gather_points)


@pytest.mark.parametrize("B,N,npoint", [(2, 256, 64), (3, 512, 128),
                                        (1, 1024, 256)])
def test_fps_matches_jax_scan(rng, B, N, npoint):
    xyz = rng.randn(B, N, 3).astype(np.float32) * 5
    ref = np.asarray(_fps_scan(jnp.asarray(xyz), npoint))
    idx, coords = furthest_point_sample_with_coords(t(xyz), npoint)
    np.testing.assert_array_equal(n(idx), ref)
    np.testing.assert_array_equal(n(coords), xyz[np.arange(B)[:, None], ref])


@pytest.mark.parametrize("N,npoint", [(256, 32), (512, 128)])
def test_fps_matches_pallas_interpret(rng, N, npoint):
    xyz = rng.randn(2, N, 3).astype(np.float32) * 3
    idx, coords = _fps_pallas(jnp.asarray(xyz), npoint, interpret=True)
    got, got_c = furthest_point_sample_with_coords(t(xyz), npoint)
    np.testing.assert_array_equal(n(got), np.asarray(idx))
    np.testing.assert_array_equal(n(got_c), np.asarray(coords))


def test_fps_ties_take_the_lowest_index():
    # a lattice: many equal min-distances at every step
    g = np.stack(np.meshgrid(np.arange(8.), np.arange(8.), np.arange(2.),
                             indexing="ij"), -1).reshape(1, -1, 3)
    g = g.astype(np.float32)
    ref = np.asarray(_fps_scan(jnp.asarray(g), 40))
    np.testing.assert_array_equal(n(fps_plain(t(g), 40)), ref)


def test_fps_duplicates_and_small_npoint(rng):
    xyz = np.repeat(rng.randn(1, 16, 3).astype(np.float32), 4, axis=1)
    ref = np.asarray(_fps_scan(jnp.asarray(xyz), 24))
    np.testing.assert_array_equal(
        n(furthest_point_sample_with_coords(t(xyz), 24)[0]), ref)
    idx, coords = furthest_point_sample_with_coords(t(xyz), 1)
    assert n(idx).tolist() == [[0]]
    np.testing.assert_array_equal(n(coords), xyz[:, :1])


def test_gather_points(rng):
    pts = rng.randn(2, 50, 5).astype(np.float32)
    idx = rng.randint(0, 50, (2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        n(gather_points(t(pts), t(idx))), pts[np.arange(2)[:, None], idx])
