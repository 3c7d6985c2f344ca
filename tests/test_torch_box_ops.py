"""The box geometry, BEV IoU, NMS and RoI pooling of the port against
ws3d_tpu.ops on the same seeded inputs: masks, keep masks, orders, top-k
indices and crop indices exact; floats within 1e-5. Ties, empty boxes and
all-invalid rows included.

The in-box masks are demanded exact on random scenes, with no point left
out near a face: both packages compute the rotation in float32 (no float64
upcast), and the test asserts that its scenes hold points within 1e-4 of
a face, where an ulp of cos / sin between XLA and PyTorch could flip a
`<=`."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ws3d_tpu.ops as J
import ws3d_tpu_torch.ops as T
from torch_port_helpers import n, t
from ws3d_tpu.ops.iou3d import _bev_corners as j_bev_corners
from ws3d_tpu.ops.iou3d import aligned_overlap_bev as j_aligned
from ws3d_tpu_torch.ops.iou3d import _bev_corners, aligned_overlap_bev

ATOL = 1e-5


def _boxes(rng, M, spread=6.0):
    b = np.zeros((M, 7), np.float32)
    b[:, [0, 2]] = rng.randn(M, 2) * spread
    b[:, 1] = 1.65 + rng.randn(M) * 0.1
    b[:, 3:6] = np.array([1.5, 1.6, 3.9], np.float32) * (
        1 + rng.randn(M, 3) * 0.1)
    b[:, 6] = rng.uniform(-math.pi, math.pi, M)
    return b


def _scene(rng, N, boxes):
    """N points: half uniform in the scene, half near the box centres."""
    pts = rng.uniform(-15, 15, (N, 3)).astype(np.float32)
    pts[:, 1] = rng.uniform(-1, 3, N)
    near = N // 2
    k = rng.randint(0, len(boxes), near)
    pts[:near] = boxes[k, :3] + rng.randn(near, 3).astype(np.float32) * [
        1.5, 0.6, 1.5]
    return pts.astype(np.float32)


def _bev(rng, K, spread=3.0):
    return np.array(J.boxes3d_to_bev(jnp.asarray(_boxes(rng, K, spread))))


def _face_margin(pts, boxes):
    """Least distance of any point to a face of any box, in the box frame
    (float64)."""
    p, b = pts.astype(np.float64), boxes.astype(np.float64)
    shift = p[:, None, :] - b[None, :, :3]
    c, s = np.cos(b[:, 6]), np.sin(b[:, 6])
    x = shift[..., 0] * c - shift[..., 2] * s
    z = shift[..., 0] * s + shift[..., 2] * c
    y = shift[..., 1] + b[:, 3] / 2
    return min(np.abs(np.abs(x) - b[:, 5] / 2).min(),
               np.abs(np.abs(z) - b[:, 4] / 2).min(),
               np.abs(np.abs(y) - b[:, 3] / 2).min())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_points_in_rotated_boxes_exact(seed):
    rng = np.random.RandomState(seed)
    boxes = _boxes(rng, 12)
    pts = _scene(rng, 4096, boxes)
    assert _face_margin(pts, boxes) < 1e-4
    ref = np.asarray(J.points_in_rotated_boxes(jnp.asarray(pts),
                                               jnp.asarray(boxes)))
    got = n(T.points_in_rotated_boxes(t(pts), t(boxes)))
    assert ref.any() and not ref.all()
    np.testing.assert_array_equal(got, ref)


def test_box_geometry():
    rng = np.random.RandomState(3)
    boxes = _boxes(rng, 32)
    np.testing.assert_allclose(
        n(T.enlarge_box3d(t(boxes), 0.2)),
        np.asarray(J.enlarge_box3d(jnp.asarray(boxes), 0.2)), atol=ATOL)
    ang = boxes[:, 6]
    np.testing.assert_allclose(
        n(T.rotation_matrix_y(t(ang))),
        np.asarray(J.rotation_matrix_y(jnp.asarray(ang))), atol=ATOL)
    bev = _bev(rng, 32)
    np.testing.assert_allclose(n(_bev_corners(t(bev))),
                               np.asarray(j_bev_corners(jnp.asarray(bev))),
                               atol=ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_bev_iou(seed):
    rng = np.random.RandomState(seed)
    a, b = _bev(rng, 24, 2.0), _bev(rng, 20, 2.0)
    a[3] = b[5]                                   # identical pair
    ref = np.asarray(J.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = n(T.boxes_iou_bev(t(a), t(b)))
    assert (ref > 0).sum() > 10 and ref[3, 5] > 0.999
    np.testing.assert_allclose(got, ref, atol=ATOL)
    ref = np.asarray(j_aligned(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(n(aligned_overlap_bev(t(a), t(b))), ref,
                               atol=ATOL)


def _nms_case(rng, K, ties: bool):
    bev = _bev(rng, K, 2.0)
    scores = rng.rand(K).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4             # many equal scores
    valid = rng.rand(K) > 0.2
    return bev, scores.astype(np.float32), valid


@pytest.mark.parametrize("rotated", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_rotated_nms(rotated, ties):
    rng = np.random.RandomState(7)
    bev, scores, valid = _nms_case(rng, 48, ties)
    for v in (valid, None, np.zeros_like(valid)):
        kref, oref = J.rotated_nms(jnp.asarray(bev), jnp.asarray(scores),
                                   0.3, None if v is None else
                                   jnp.asarray(v), rotated=rotated)
        keep, order = T.rotated_nms(t(bev), t(scores), 0.3,
                                    None if v is None else t(v),
                                    rotated=rotated)
        np.testing.assert_array_equal(n(order), np.asarray(oref))
        np.testing.assert_array_equal(n(keep), np.asarray(kref))
        if v is not None and not v.any():
            assert not n(keep).any()
        else:
            assert 0 < n(keep).sum() < len(scores)


@pytest.mark.parametrize("ties", [False, True])
def test_radius_nms(ties):
    rng = np.random.RandomState(8)
    xz = (rng.randn(64, 2) * 3).astype(np.float32)
    scores = rng.rand(64).astype(np.float32)
    if ties:
        scores = (np.round(scores * 3) / 3).astype(np.float32)
    valid = rng.rand(64) > 0.25
    for v in (valid, None, np.zeros_like(valid)):
        kref, oref = J.radius_nms(jnp.asarray(xz), jnp.asarray(scores), 1.4,
                                  None if v is None else jnp.asarray(v))
        keep, order = T.radius_nms(t(xz), t(scores), 1.4,
                                   None if v is None else t(v))
        np.testing.assert_array_equal(n(order), np.asarray(oref))
        np.testing.assert_array_equal(n(keep), np.asarray(kref))


@pytest.mark.parametrize("ties", [False, True])
def test_score_threshold_topk(ties):
    rng = np.random.RandomState(9)
    scores = rng.rand(256).astype(np.float32)
    if ties:
        scores = (np.round(scores * 5) / 5).astype(np.float32)
    valid = rng.rand(256) > 0.3
    for v in (valid, None, np.zeros_like(valid)):
        iref, okref = J.score_threshold_topk(
            jnp.asarray(scores), 0.5, 64,
            None if v is None else jnp.asarray(v))
        idx, ok = T.score_threshold_topk(t(scores), 0.5, 64,
                                         None if v is None else t(v))
        np.testing.assert_array_equal(n(idx), np.asarray(iref))
        np.testing.assert_array_equal(n(ok), np.asarray(okref))


def test_roipool3d():
    rng = np.random.RandomState(10)
    boxes = _boxes(rng, 10, 5.0)
    pts = _scene(rng, 2048, boxes)
    boxes[7, :3] = [100.0, 1.65, 100.0]                 # an empty box
    feats = rng.rand(2048, 2).astype(np.float32)
    for k in (16, 512):                  # full crops and wraparound
        pref, eref = J.roipool3d(jnp.asarray(pts), jnp.asarray(feats),
                                 jnp.asarray(boxes), 1.0, k)
        pooled, empty = T.roipool3d(t(pts), t(feats), t(boxes), 1.0, k)
        np.testing.assert_array_equal(n(empty), np.asarray(eref))
        assert n(empty)[7] and not n(empty).all()
        # the pooled rows are gathered, not computed: equal indices give
        # bit-equal rows
        np.testing.assert_array_equal(n(pooled), np.asarray(pref))


def test_cylinder_crop():
    rng = np.random.RandomState(11)
    pts = rng.uniform(-10, 10, (2048, 3)).astype(np.float32)
    feats = rng.rand(2048, 3).astype(np.float32)
    centers = rng.uniform(-8, 8, (12, 2)).astype(np.float32)
    centers[4] = [60.0, 60.0]                           # empty crop
    for k in (32, 512):
        xr, fr, er = J.cylinder_crop(jnp.asarray(pts), jnp.asarray(feats),
                                     jnp.asarray(centers), 4.0, k)
        xyz, f, empty = T.cylinder_crop(t(pts), t(feats), t(centers), 4.0, k)
        np.testing.assert_array_equal(n(empty), np.asarray(er))
        assert n(empty)[4] and not n(empty).all()
        np.testing.assert_array_equal(n(f), np.asarray(fr))
        np.testing.assert_allclose(n(xyz), np.asarray(xr), atol=ATOL)


def test_ops_exports_match():
    names = ("boxes3d_to_corners3d", "boxes3d_to_bev", "enlarge_box3d",
             "rotate_points_along_y", "rotation_matrix_y",
             "points_in_rotated_boxes", "rotated_overlap_bev",
             "boxes_iou_bev", "boxes_iou3d", "rotated_nms", "radius_nms",
             "score_threshold_topk", "roipool3d", "cylinder_crop",
             "paired_iou3d", "paired_giou3d", "ious_3d_loss",
             "gious_3d_loss")
    for name in names:
        assert callable(getattr(J, name)) and callable(getattr(T, name)), \
            name
    assert isinstance(T.rotation_matrix_y(torch.zeros(2)), torch.Tensor)
