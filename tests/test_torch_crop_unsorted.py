"""The stage-2 crop on scenes that are not sorted by z: the port's
crop_for_rcnn_batched against the JAX package's (its CPU path: the first
512 members in point order, `s % cnt` slots, a stable sort of each crop by
z) on one unsorted scene of N = 4,096 points and the same scene sorted,
K = 8 centres, four of them on clusters of more than 512 points. The crops
must be bit-equal. make_two_stage_fn, whose EVAL scenes are sorted, keeps
kernel 5's grouped mode."""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import n, t
from ws3d_tpu.pipeline.inference import crop_for_rcnn_batched as jax_crop
from ws3d_tpu_torch.pipeline import inference as tinf

N, K, S = 4096, 8, 512
CLUSTERS = ((-6.0, 12.0), (3.0, 20.0), (8.0, 31.0), (-2.0, 38.0))


def _scene(seed: int = 5):
    """(N, 4) points in generator order: a sparse floor and four dense
    clusters of 650 points within 3 m of their centres; the K centres."""
    rs = np.random.RandomState(seed)
    floor = np.stack([rs.uniform(-20, 20, 1496), rs.uniform(-2, 1, 1496),
                      rs.uniform(0, 45, 1496)], -1)
    blobs = []
    for cx, cz in CLUSTERS:
        r = 3.0 * np.sqrt(rs.rand(650))
        a = rs.uniform(0, 2 * np.pi, 650)
        blobs.append(np.stack([cx + r * np.cos(a), rs.uniform(-1.5, 0.5, 650),
                               cz + r * np.sin(a)], -1))
    xyz = np.concatenate([floor] + blobs)
    pts = np.concatenate([xyz, rs.rand(N, 1) - 0.5], -1).astype(np.float32)
    pts = pts[rs.permutation(N)]
    centers = np.array(list(CLUSTERS) + [(0.0, 5.0), (15.0, 40.0),
                                         (90.0, 90.0), (-6.5, 12.5)],
                       np.float32)
    scores = rs.rand(N).astype(np.float32)
    return pts, scores, centers


def _sorted(pts, scores):
    order = np.argsort(pts[:, 2], kind="stable")
    return pts[order], scores[order]


@pytest.fixture(scope="module")
def scenes():
    pts, scores, centers = _scene()
    spts, sscores = _sorted(pts, scores)
    assert (np.diff(pts[:, 2]) < 0).mean() > 0.4          # unsorted
    return {"unsorted": (pts, scores, centers),
            "sorted": (spts, sscores, centers)}


def _both(pts, scores, centers, **kw):
    ref, ref_empty = jax_crop(jnp.asarray(pts[None]), jnp.asarray(scores[None]),
                              jnp.asarray(centers[None]), num_sampled=S)
    got, got_empty = tinf.crop_for_rcnn_batched(
        t(pts[None]), t(scores[None]), t(centers[None]), num_sampled=S, **kw)
    return ({k: np.asarray(v) for k, v in ref.items()}, np.asarray(ref_empty),
            {k: n(v) for k, v in got.items()}, n(got_empty))


@pytest.mark.parametrize("which", ["unsorted", "sorted"])
def test_crop_bit_equal_to_jax(scenes, which):
    pts, scores, centers = scenes[which]
    ref, ref_empty, got, got_empty = _both(pts, scores, centers)
    np.testing.assert_array_equal(got_empty, ref_empty)
    assert ref_empty[0].tolist() == [False] * 6 + [True, False]
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    z = got["cur_box_point"][0, ..., 2]
    assert (np.diff(z, axis=-1) >= 0).all()                # z-sorted crops


def test_clusters_overfill_their_crops(scenes):
    pts, _, centers = scenes["unsorted"]
    d2 = ((pts[None, :, 0] - centers[:, None, 0]) ** 2
          + (pts[None, :, 2] - centers[:, None, 1]) ** 2)
    counts = (d2 < 16.0).sum(1)
    assert (counts[:4] > S).all() and counts[6] == 0


def test_promised_sorted_scene_takes_the_grouped_order(scenes):
    """On a sorted scene (distinct z) kernel 5's grouped order is the JAX
    crop already."""
    pts, scores, centers = scenes["sorted"]
    ref, _, got, _ = _both(pts, scores, centers, scene_sorted=True)
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_two_stage_keeps_the_grouped_mode(monkeypatch):
    from torch_port_helpers import synthetic_batch, torch_detector
    calls = []
    orig = tinf.crop_gather

    def rec(*args, **kw):
        calls.append(kw.get("grouped"))
        return orig(*args, **kw)
    monkeypatch.setattr(tinf, "crop_gather", rec)
    model, cfg = torch_detector()
    tinf.make_two_stage_fn(model, cfg, max_proposals=8)(
        t(synthetic_batch(1, 4096)))
    assert calls == [True]
