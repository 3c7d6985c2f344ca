"""TRAIN batches: the port's RPNDataset gives the JAX package's batches bit
for bit for the same seed (the shared RNG stream consumed in the same
order: shuffle, near/far sample, augmentation), including the weak-scene
filter and the Gaussian labels."""
import numpy as np
import pytest

from ws3d_tpu.config import load_config as jax_config
from ws3d_tpu.datasets import SyntheticKitti as JaxSynthetic
from ws3d_tpu.datasets.rpn_dataset import RPNDataset as JaxRPNDataset
from ws3d_tpu.datasets.rpn_dataset import (augment_scene as jax_augment,
                                           gaussian_weak_labels as jax_labels)
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
from ws3d_tpu_torch.datasets.rpn_dataset import (augment_scene,
                                                 gaussian_weak_labels)


@pytest.mark.parametrize("npoints,weakly_num,seed", [(2048, None, 0),
                                                     (1024, 5, 7)])
def test_train_batches_bit_for_bit(npoints, weakly_num, seed):
    kw = dict(num_scenes=8, points_per_scene=12000, seed=3)
    ref_ds = JaxRPNDataset(JaxSynthetic(**kw), jax_config(), mode="TRAIN",
                           npoints=npoints, weakly_num=weakly_num, seed=seed)
    ds = RPNDataset(SyntheticKitti(**kw), load_config(), mode="TRAIN",
                    npoints=npoints, weakly_num=weakly_num, seed=seed)
    assert ds.sample_ids == ref_ds.sample_ids
    ref = list(ref_ds.batches(batch_size=2, steps=5))
    got = list(ds.batches(batch_size=2, steps=5, shuffle=True))
    assert len(got) == len(ref) == 5
    for r, g in zip(ref, got):
        assert set(g) <= set(r)
        for k in g:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert g["rpn_cls_label"].max() > 0
        assert (np.diff(g["pts_input"][..., 2], axis=1) >= 0).all()


def test_augmentation_and_labels_match(rng):
    pts = rng.randn(500, 3).astype(np.float32) * 10
    boxes = rng.randn(3, 7).astype(np.float32) * 5
    a = augment_scene(pts, boxes, np.random.RandomState(4))
    b = jax_augment(pts, boxes, np.random.RandomState(4))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert [m[0] for m in a[2]] == [m[0] for m in b[2]]
    for centres in (boxes[:, :3], np.zeros((0, 3), np.float32)):
        for x, y in zip(gaussian_weak_labels(pts, centres),
                        jax_labels(pts, centres)):
            np.testing.assert_array_equal(x, y)


def test_gt_database_is_refused():
    """A GT database is taken now (it was refused before the augmentation
    was ported): an empty one pastes nothing, but the apply-probability
    draw still consumes the stream, as in the JAX loader; a batch larger
    than the scene count is refused."""
    src = SyntheticKitti(num_scenes=2, points_per_scene=3000, seed=1)
    jsrc = JaxSynthetic(num_scenes=2, points_per_scene=3000, seed=1)
    got = next(RPNDataset(src, load_config(), mode="TRAIN", npoints=1024,
                          gt_database=([], [])).batches(2, shuffle=True))
    ref = next(JaxRPNDataset(jsrc, jax_config(), mode="TRAIN", npoints=1024,
                             gt_database=([], [])).batches(2))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with pytest.raises(ValueError):
        next(RPNDataset(src, load_config(), mode="TRAIN").batches(3))
