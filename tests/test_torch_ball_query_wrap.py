"""Kernel 6w (the wrap-pad ball query) on the CPU: the port's plain version
against ball_query_pallas(wrap_pad=True) in interpret mode and the BEV
first-k search against the JAX pipeline's XLA composition. Indices and
counts exact."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu.ops.ball_query_pallas import ball_query_pallas
from ws3d_tpu.pipeline.inference import (
    _bev_first_k_wrap as jax_bev_first_k_wrap,
    _bev_first_k_wrap_batched as jax_bev_first_k_wrap_batched)
from ws3d_tpu_torch.ops.ball_query import (ball_query_wrap,
                                           ball_query_wrap_plain)
from ws3d_tpu_torch.pipeline.inference import (bev_first_k_wrap,
                                               bev_first_k_wrap_batched)


def _cloud(rng, B, N, M, spread=2.0):
    xyz = rng.randn(B, N, 3).astype(np.float32) * spread
    q = xyz[:, rng.choice(N, M, replace=False)].copy()
    q[:, 0] = 50.0                              # an empty ball
    q[:, 1] = xyz[:, 7]                         # a dense one (cnt > S)
    return xyz, q


@pytest.mark.parametrize("radii,nsamples", [([0.6], [16]),
                                            ([0.3, 1.0], [8, 200])])
def test_plain_matches_pallas_wrap_pad(rng, radii, nsamples):
    xyz, q = _cloud(rng, 2, 512, 16)
    (ref_idx, ref_cnt) = ball_query_pallas(radii, nsamples, jnp.asarray(xyz),
                                           jnp.asarray(q), interpret=True,
                                           wrap_pad=True)
    idx, cnt = ball_query_wrap_plain(radii, nsamples, t(xyz), t(q))
    for a, b in zip(idx + cnt, tuple(ref_idx) + tuple(ref_cnt)):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(n(a), np.asarray(b))
    c = n(cnt[-1])
    assert (c[:, 0] == 0).all() and (n(idx[-1])[:, 0] == 0).all()
    # balls with fewer hits than slots wrap around s % cnt
    partial = (c > 0) & (c < nsamples[-1])
    assert partial.any()
    rows = n(idx[-1])[partial]
    cs = c[partial]
    for row, cc in zip(rows, cs):
        np.testing.assert_array_equal(row, np.resize(row[:cc], len(row)))


def test_dispatch_and_chunks_agree_on_cpu(rng):
    xyz, q = _cloud(rng, 2, 384, 40)
    args = ([0.5, 1.5], [24, 48], t(xyz), t(q))
    a = ball_query_wrap(*args)
    b = ball_query_wrap_plain(*args, chunk=7)
    for x, y in zip(a[0] + a[1], b[0] + b[1]):
        assert torch.equal(x, y)


def test_scale_checks():
    xyz = torch.zeros(1, 8, 3)
    with pytest.raises(ValueError):
        from ws3d_tpu_torch.ops.ball_query import _scale_args
        _scale_args([1.0] * 5, [4] * 5, "ball_query_wrap")
    with pytest.raises(ValueError):
        from ws3d_tpu_torch.ops.ball_query import ball_query_wrap_cuda
        ball_query_wrap_cuda([1.0], [0], xyz, xyz)


@pytest.mark.parametrize("S", [64, 1000])
def test_bev_first_k_wrap_matches_jax(rng, S):
    """The BEV search with y zeroed equals the JAX pipeline's x/z distance
    (its XLA path on the CPU), counts included; S = 1000 > N too."""
    B, N, K = 2, 600, 8
    xyz = rng.randn(B, N, 3).astype(np.float32) * 5
    centers = rng.randn(B, K, 2).astype(np.float32) * 5
    centers[:, 0] = 90.0
    idx, cnt = bev_first_k_wrap_batched(t(xyz), t(centers), 4.0, S)
    ref_idx, ref_empty = jax_bev_first_k_wrap_batched(
        jnp.asarray(xyz), jnp.asarray(centers), 4.0, S)
    np.testing.assert_array_equal(n(idx), np.asarray(ref_idx))
    np.testing.assert_array_equal(n(cnt) == 0, np.asarray(ref_empty))
    d2 = ((xyz[:, None, :, 0] - centers[..., 0:1]) ** 2
          + (xyz[:, None, :, 2] - centers[..., 1:2]) ** 2)
    np.testing.assert_array_equal(n(cnt), (d2 < 16.0).sum(-1))
    one_idx, one_cnt = bev_first_k_wrap(t(xyz[1]), t(centers[1]), 4.0, S)
    ref1, _ = jax_bev_first_k_wrap(jnp.asarray(xyz[1]),
                                   jnp.asarray(centers[1]), 4.0, S)
    np.testing.assert_array_equal(n(one_idx), np.asarray(ref1))
    np.testing.assert_array_equal(n(one_cnt), n(cnt[1]))
