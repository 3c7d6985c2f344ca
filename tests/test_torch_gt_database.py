"""The GT-database copy-paste augmentation of the port against the JAX
package: the host sampling helpers equal, the databases built from the
same synthetic scenes equal entry for entry (the in-box masks exact), one
apply_gt_aug equal on one RandomState, and augmented TRAIN batches of
RPNDataset(gt_database=...) bit-equal for three seeds, also when a scene
carries more boxes than MAX_GT."""
import functools

import numpy as np
import pytest

from ws3d_tpu.config import load_config as jax_config
from ws3d_tpu.datasets import SyntheticKitti as JaxSynthetic
from ws3d_tpu.datasets import gt_database as jdb
from ws3d_tpu.datasets import rpn_dataset as jrpn
from ws3d_tpu.utils import sampling_np as jsamp
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets import SyntheticKitti
from ws3d_tpu_torch.datasets import gt_database as tdb
from ws3d_tpu_torch.datasets import rpn_dataset as trpn
from ws3d_tpu_torch.utils import sampling_np as tsamp

DB_SCENES = 8
NPOINTS = 4096


@functools.lru_cache(maxsize=None)
def databases(seed=5):
    """((easy, hard) of the JAX package, (easy, hard) of the port) from the
    same synthetic scenes."""
    jsrc = JaxSynthetic(num_scenes=DB_SCENES, points_per_scene=20000,
                        seed=seed)
    tsrc = SyntheticKitti(num_scenes=DB_SCENES, points_per_scene=20000,
                          seed=seed)
    return (jdb.build_gt_database(jsrc, jsrc.sample_ids),
            tdb.build_gt_database(tsrc, tsrc.sample_ids))


def _assert_same(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
            np.testing.assert_array_equal(y, x, err_msg=f"{what} {k}")
        else:
            assert x == y, (what, k)


def test_sampling_helpers_equal():
    rng = np.random.RandomState(0)
    pts = rng.randn(500, 3).astype(np.float32)
    for k, start in ((100, 0), (7, 13), (600, 2)):
        np.testing.assert_array_equal(
            tsamp.greedy_furthest_point_sample(pts, k, start),
            jsamp.greedy_furthest_point_sample(pts, k, start))
    w = rng.rand(50)
    w[::4] = 0.0
    for k in (5, 40, 0):
        np.testing.assert_array_equal(
            tsamp.weighted_sample(w, k, np.random.RandomState(3)),
            jsamp.weighted_sample(w, k, np.random.RandomState(3)))


def test_database_equal_entry_for_entry():
    (jeasy, jhard), (teasy, thard) = databases()
    assert len(jeasy) == len(teasy) > 0 and len(jhard) == len(thard) > 0
    for kind, a, b in (("easy", jeasy, teasy), ("hard", jhard, thard)):
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{kind}[{i}]")


def test_apply_gt_aug_equal():
    (jeasy, jhard), (teasy, thard) = databases()
    rng = np.random.RandomState(2)
    pts = rng.uniform(-30, 30, (6000, 3))
    pts[:, 2] = np.abs(pts[:, 2])
    inten = rng.rand(6000).astype(np.float32)
    boxes = np.array([[2.0, 1.6, 20.0, 1.5, 1.6, 3.9, 0.3]], np.float32)
    ref = jdb.apply_gt_aug(pts, inten, boxes, jeasy, jhard,
                           np.random.RandomState(9))
    got = tdb.apply_gt_aug(pts, inten, boxes, teasy, thard,
                           np.random.RandomState(9))
    assert ref[2].shape[0] > 1
    for x, y in zip(ref, got):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(y, x)
    empty = tdb.apply_gt_aug(pts, inten, boxes, [], thard,
                             np.random.RandomState(9))
    assert empty[0] is pts and empty[2].shape == (0, 7)


def _train_batches(seed, n_batches=2, batch=2):
    (jeasy, jhard), (teasy, thard) = databases()
    jsrc = JaxSynthetic(num_scenes=4, points_per_scene=20000, seed=seed)
    tsrc = SyntheticKitti(num_scenes=4, points_per_scene=20000, seed=seed)
    jds = jrpn.RPNDataset(jsrc, jax_config(), mode="TRAIN", npoints=NPOINTS,
                          seed=seed, gt_database=(jeasy, jhard))
    tds = trpn.RPNDataset(tsrc, load_config(), mode="TRAIN",
                          npoints=NPOINTS, seed=seed,
                          gt_database=(teasy, thard))
    return (list(jds.batches(batch, steps=n_batches, shuffle=True)),
            list(tds.batches(batch, steps=n_batches, shuffle=True)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmented_train_batches_bit_equal(seed):
    ref, got = _train_batches(seed)
    for i, (a, b) in enumerate(zip(ref, got)):
        _assert_same(a, b, f"batch {i}")
    # the scenes carry pasted instances: more boxes than their weak labels
    jsrc = JaxSynthetic(num_scenes=4, points_per_scene=20000, seed=seed)
    n_weak = max(len(jsrc.get_scene(i).noise_labels) for i in range(4))
    assert max(int(b["gt_count"].max()) for b in got) > n_weak


def test_more_boxes_than_max_gt(monkeypatch):
    """With MAX_GT cut to 4 in both packages, the pasted scenes carry more
    boxes than it: every box labels the points, the first MAX_GT are kept,
    as the JAX loader does."""
    monkeypatch.setattr(jrpn, "MAX_GT", 4)
    monkeypatch.setattr(trpn, "MAX_GT", 4)
    ref, got = _train_batches(0, n_batches=1)
    assert int(got[0]["gt_count"].min()) == 4
    assert got[0]["gt_boxes3d"].shape == (2, 4, 7)
    _assert_same(ref[0], got[0], "batch 0")


def test_gt_aug_off_keeps_the_stream():
    """GT_AUG_ENABLED off: no draw for the apply probability, the batches
    of a loader without a database."""
    (_, _), (teasy, thard) = databases()
    cfg = load_config()
    cfg.GT_AUG_ENABLED = False
    src = SyntheticKitti(num_scenes=4, points_per_scene=20000, seed=0)
    a = trpn.RPNDataset(src, cfg, mode="TRAIN", npoints=NPOINTS, seed=0,
                        gt_database=(teasy, thard))
    b = trpn.RPNDataset(src, cfg, mode="TRAIN", npoints=NPOINTS, seed=0)
    _assert_same(next(a.batches(2, steps=1, shuffle=True)),
                 next(b.batches(2, steps=1, shuffle=True)), "batch")
