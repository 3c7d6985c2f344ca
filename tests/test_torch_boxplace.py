"""The stage-2 crop loader (BoxPlaceDataset, synthetic_proposal_database)
against the JAX package's: the same database for the same seed, and the
same TRAIN and EVAL batches bit for bit, with and without the IOUN
cascade jitter, with a weakly-labelled budget, at the crop size of the
tests and at the shipped 512 points."""
import numpy as np
import pytest

from ws3d_tpu.config import load_config as jax_config
from ws3d_tpu.datasets.boxplace_dataset import BoxPlaceDataset as JaxDataset
from ws3d_tpu.datasets.boxplace_dataset import \
    synthetic_proposal_database as jax_db
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets import (BoxPlaceDataset,
                                     synthetic_proposal_database)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("crop_points", [128, 512])
def test_synthetic_database_is_identical(crop_points):
    ref = jax_db(num=10, seed=7, crop_points=crop_points)
    got = synthetic_proposal_database(num=10, seed=7,
                                      crop_points=crop_points)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        _assert_same(a, b)


@pytest.mark.parametrize("mode,ioun,weakly", [
    ("TRAIN", False, None), ("TRAIN", True, None), ("TRAIN", True, 0.5),
    ("EVAL", True, None), ("EVAL", False, None)])
def test_batches_are_identical(mode, ioun, weakly):
    db = jax_db(num=12, seed=3, crop_points=128)
    cfgs = [jax_config(), load_config()]
    for cfg in cfgs:
        cfg.IOUN.ENABLED = ioun
        cfg.CASCADE = 2 if ioun else 1
    ref = JaxDataset(db, cfgs[0], mode=mode, npoints=96, seed=1,
                     weakly_ratio=weakly)
    got = BoxPlaceDataset(synthetic_proposal_database(num=12, seed=3,
                                                      crop_points=128),
                          cfgs[1], mode=mode, npoints=96, seed=1,
                          weakly_ratio=weakly)
    assert len(got) == len(ref)
    n = 0
    for a, b in zip(got.batches(4, steps=3, prob_mask_ratio=0.5),
                    ref.batches(4, steps=3, prob_mask_ratio=0.5)):
        _assert_same(a, b)
        n += 1
    assert n == 3
    if ioun:
        assert a["iou_trans"].shape == (4, 3, 2)
    assert np.all(np.diff(a["cur_box_point"][..., 2], axis=1) >= 0)
