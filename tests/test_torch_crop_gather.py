"""Kernel 5 (crop-gather) and the crop glue: the port's plain version
against the Pallas kernel in interpret mode (its gather is exact one-hot
f32, so values and counts match exactly) and against the JAX package's XLA
crop path."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from ws3d_tpu.ops.ball_query_pallas import crop_gather_pallas
from ws3d_tpu.ops.roipool import _first_k_wraparound
from ws3d_tpu.pipeline.inference import crop_for_rcnn_batched as jax_crop
from ws3d_tpu_torch.ops.crop_gather import crop_gather, slot_members
from ws3d_tpu_torch.ops.roipool import first_k_wraparound
from ws3d_tpu_torch.pipeline.inference import crop_for_rcnn_batched


def _scene(rng, B, N, spread=6.0):
    pts = rng.randn(B, N, 4).astype(np.float32)
    pts[..., :3] *= spread
    order = np.argsort(pts[..., 2], axis=1, kind="stable")
    return pts[np.arange(B)[:, None], order]


def _centers(rng, B, M):
    c = rng.randn(B, M, 2).astype(np.float32) * 6
    c[:, 0] = [60.0, 60.0]            # an empty crop
    c[:, 1] = [0.0, 0.0]              # a dense one (cnt > k)
    return c


@pytest.mark.parametrize("grouped", [True, False])
def test_crop_gather_matches_pallas_interpret(rng, grouped):
    B, N, M, k = 2, 512, 8, 64
    pts = _scene(rng, B, N)
    ch = np.ascontiguousarray(np.concatenate(
        [pts.transpose(0, 2, 1), rng.rand(B, 1, N).astype(np.float32)], 1))
    centers = _centers(rng, B, M)
    vals, cnt = crop_gather_pallas(jnp.asarray(pts[..., :3]), jnp.asarray(ch),
                                   jnp.asarray(centers), 4.0, k,
                                   grouped=grouped, interpret=True,
                                   z_window=None)
    got, got_cnt = crop_gather(t(pts[..., :3]), t(ch), t(centers), 4.0, k,
                               grouped=grouped)
    np.testing.assert_array_equal(n(got_cnt), np.asarray(cnt))
    np.testing.assert_array_equal(n(got), np.stack([np.asarray(v)
                                                    for v in vals]))
    c = n(got_cnt)
    assert c[0, 0] == 0 and c[0, 1] > k          # empty and overfull crops
    assert ((0 < c) & (c < k) & (k % np.maximum(c, 1) != 0)).any()
    assert (n(got)[:, 0, 0] == 0).all()


def test_slot_members_grouped_formula():
    cnt = np.array([1, 3, 5, 7, 64, 100])
    j = n(slot_members(t(cnt), 16, grouped=True))
    for c, row in zip(cnt, j):
        if c >= 16:
            assert row.tolist() == list(range(16))
            continue
        # each member repeats k//c or k//c + 1 times, first ones more, in order
        reps = np.bincount(row, minlength=c)
        assert reps.tolist() == [16 // c + (i < 16 % c) for i in range(c)]
        assert (np.diff(row) >= 0).all()
    wrap = n(slot_members(t(cnt), 16, grouped=False))
    assert wrap[1].tolist() == [s % 3 for s in range(16)]


def test_first_k_wraparound_matches_jax(rng):
    mask = rng.rand(6, 300) < 0.03
    mask[0] = False
    idx, empty = _first_k_wraparound(jnp.asarray(mask), 32)
    got, got_empty = first_k_wraparound(t(mask), 32)
    np.testing.assert_array_equal(n(got), np.asarray(idx))
    np.testing.assert_array_equal(n(got_empty), np.asarray(empty))


def test_crop_for_rcnn_matches_jax_xla_path(rng):
    B, N, M, k = 2, 384, 8, 64
    pts = _scene(rng, B, N)
    scores = rng.rand(B, N).astype(np.float32)
    centers = _centers(rng, B, M)
    ref, ref_empty = jax_crop(jnp.asarray(pts), jnp.asarray(scores),
                              jnp.asarray(centers), num_sampled=k)
    got, got_empty = crop_for_rcnn_batched(t(pts), t(scores), t(centers),
                                           num_sampled=k)
    np.testing.assert_array_equal(n(got_empty), np.asarray(ref_empty))
    # the JAX XLA tail stable-sorts the `s % cnt` list by z; the kernel's
    # grouped order is the same wherever no two distinct members share a z
    for key in ("cur_box_point", "cur_box_reflect", "train_mask"):
        np.testing.assert_allclose(n(got[key]), np.asarray(ref[key]),
                                   atol=1e-6, rtol=0)
