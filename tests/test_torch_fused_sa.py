"""Kernels 2 and 3 (fused SA, windowed and full) and the plain grouping
pieces: the port's plain version against the JAX XLA composition (indices
exact, floats atol 1e-4) and the Pallas kernels in interpret mode (floats
2e-2, the precedent of tests/test_fused_sa_bq.py: the TPU kernels round to
bf16 inside)."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, random_mlp, sorted_cloud, t
from ws3d_tpu.ops import grouping as jg
from ws3d_tpu.ops.fused_sa_bq_pallas import _xla_reference, fused_sa_ballquery
from ws3d_tpu.ops.fused_sa_window_pallas import fused_sa_window
from ws3d_tpu_torch.models.pointnet2 import use_window
from ws3d_tpu_torch.ops import grouping as tg
from ws3d_tpu_torch.ops.fused_sa import fused_sa, fused_sa_plain


def _jx(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("radius,S", [(0.3, 8), (0.8, 16), (2.0, 32)])
def test_ball_query_indices_exact(rng, radius, S):
    xyz, _ = sorted_cloud(rng, 2, 384, 1)
    new_xyz = xyz[:, ::6]
    ref = np.asarray(jg.ball_query(radius, S, *_jx(xyz, new_xyz),
                                   force_xla=True))
    got = n(tg.ball_query(radius, S, t(xyz), t(new_xyz), chunk=16))
    np.testing.assert_array_equal(got, ref)


def test_ball_query_empty_and_overfull(rng):
    xyz = rng.rand(1, 128, 3).astype(np.float32)           # unit cube
    new_xyz = np.array([[[50., 50., 50.], [0.5, 0.5, 0.5],
                         [0.0, 0.0, 0.0]]], np.float32)
    ref = np.asarray(jg.ball_query(3.0, 16, *_jx(xyz, new_xyz),
                                   force_xla=True))
    got = n(tg.ball_query(3.0, 16, t(xyz), t(new_xyz)))
    np.testing.assert_array_equal(got, ref)
    # empty ball -> all zeros; 128 points in a 3-ball -> the first 16
    small = n(tg.ball_query(0.05, 8, t(xyz), t(new_xyz)))
    assert (small[0, 0] == 0).all()
    np.testing.assert_array_equal(got[0, 1], np.arange(16))


def test_first_k_and_group_helpers(rng):
    mask = rng.rand(3, 5, 200) < 0.1
    np.testing.assert_array_equal(
        n(tg.first_k_true_indices(t(mask), 12)),
        np.asarray(jg.first_k_true_indices(jnp.asarray(mask), 12)))
    xyz, feat = sorted_cloud(rng, 2, 64, 3)
    idx = rng.randint(0, 64, (2, 8, 4)).astype(np.int32)
    new_xyz = xyz[:, :8]
    np.testing.assert_array_equal(
        n(tg.group_with_idx(t(idx).long(), t(xyz), t(new_xyz), t(feat))),
        np.asarray(jg.group_with_idx(*_jx(idx, xyz, new_xyz, feat))))
    np.testing.assert_array_equal(
        n(tg.group_all(t(xyz), t(feat))),
        np.asarray(jg.group_all(*_jx(xyz, feat))))


CASES = [  # (P, M, C, radius, S, widths)
    (512, 128, 1, 0.5, 16, [16, 16, 32]),
    (256, 64, 6, 1.0, 32, [32, 24, 48]),
    (128, 32, 8, 1.5, 64, [32, 32, 64]),
]


@pytest.mark.parametrize("P,M,C,radius,S,widths", CASES)
def test_fused_sa_plain_matches_xla_reference(rng, P, M, C, radius, S,
                                              widths):
    xyz, feat = sorted_cloud(rng, 2, P, C)
    new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))]
    ks, bs = random_mlp(rng, 3 + C, widths)
    ref = _xla_reference(*_jx(xyz, feat, new_xyz), radius, S, _jx(*ks),
                         _jx(*bs))
    for window in (True, False):     # CPU tensors take the plain version
        got = fused_sa(t(xyz), t(feat), t(new_xyz), radius, S,
                       [t(k) for k in ks], [t(b) for b in bs], window)
        np.testing.assert_allclose(n(got), np.asarray(ref), atol=1e-4,
                                   rtol=1e-5)


@pytest.mark.parametrize("P,M,C,radius,S,widths", CASES[:2])
def test_fused_sa_plain_matches_pallas_interpret(rng, P, M, C, radius, S,
                                                 widths):
    xyz, feat = sorted_cloud(rng, 2, P, C)
    new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))]
    ks, bs = random_mlp(rng, 3 + C, widths)
    got = n(fused_sa_plain(t(xyz), t(feat), t(new_xyz), radius, S,
                           [t(k) for k in ks], [t(b) for b in bs]))
    for kern in (fused_sa_window, fused_sa_ballquery):
        ref = kern(*_jx(xyz, feat, new_xyz), radius, S, _jx(*ks), _jx(*bs),
                   interpret=True)
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-2,
                                   rtol=2e-2)


def test_fused_sa_empty_ball_uses_point_zero(rng):
    xyz, feat = sorted_cloud(rng, 1, 128, 2)
    new_xyz = np.full((1, 8, 3), 100.0, np.float32)        # far from all
    ks, bs = random_mlp(rng, 5, [8, 8])
    got = n(fused_sa_plain(t(xyz), t(feat), t(new_xyz), 0.5, 8,
                           [t(k) for k in ks], [t(b) for b in bs]))
    row = np.concatenate([xyz[0, 0] - 100.0, feat[0, 0]])
    h = row
    for k, b in zip(ks, bs):
        h = np.maximum(h @ k + b, 0.0)
    np.testing.assert_allclose(got[0], np.broadcast_to(h, got[0].shape),
                               rtol=1e-5, atol=1e-5)


def test_sa_dispatch_follows_the_jax_rules():
    assert use_window(True, 16384, 1)          # backbone SA0
    assert not use_window(True, 4096, 96)      # backbone SA1 -> full
    assert use_window(True, 1024, 256)         # SA2
    assert use_window(True, 256, 512)          # SA3
    assert use_window(True, 512, 128)          # stage-2 SA0
    assert not use_window(True, 128, 128)      # stage-2 SA2 -> full
    assert not use_window(False, 512, 128)     # unsorted never windows

