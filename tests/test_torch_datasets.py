"""Host data: the port's NumPy copies give the JAX package's EVAL inputs bit
for bit for the same seeds and scenes."""
import numpy as np
import pytest

from ws3d_tpu.config import load_config as jax_config
from ws3d_tpu.datasets import SyntheticKitti as JaxSynthetic
from ws3d_tpu.datasets.rpn_dataset import RPNDataset as JaxRPNDataset
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti


@pytest.mark.parametrize("npoints,realistic", [(4096, False), (16384, False),
                                               (2048, True)])
def test_eval_pts_input_bit_for_bit(npoints, realistic):
    kw = dict(num_scenes=3, points_per_scene=20000, seed=3,
              realistic=realistic)
    ref_ds = JaxRPNDataset(JaxSynthetic(**kw), jax_config(), mode="EVAL",
                           npoints=npoints, seed=0)
    ds = RPNDataset(SyntheticKitti(**kw), load_config(), mode="EVAL",
                    npoints=npoints, seed=0)
    for i in range(3):
        ref, got = ref_ds.get_sample(i), ds.get_sample(i)
        assert got["pts_input"].dtype == np.float32
        np.testing.assert_array_equal(got["pts_input"], ref["pts_input"])
        assert int(got["gt_count"]) == int(ref["gt_count"])
        np.testing.assert_array_equal(got["gt_boxes3d"], ref["gt_boxes3d"])
        z = got["pts_input"][:, 2]
        assert (np.diff(z) >= 0).all()


def test_batches_stack_in_sample_order():
    ds = RPNDataset(SyntheticKitti(num_scenes=4, points_per_scene=6000,
                                   seed=1), load_config(), npoints=1024)
    batches = list(ds.batches(batch_size=2))
    assert len(batches) == 2
    assert batches[1]["sample_id"].tolist() == [2, 3]
    assert batches[0]["pts_input"].shape == (2, 1024, 4)
    with pytest.raises(NotImplementedError):
        RPNDataset(ds.source, load_config(), mode="TRAIN")
