"""The npz weight loader: all-or-nothing over ws3d_tpu/data/bench_weights.npz."""
import numpy as np
import pytest
import torch

from torch_port_helpers import WEIGHTS
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.weights import load_flat, load_npz, npz_key


@pytest.fixture(scope="module")
def flat():
    with np.load(WEIGHTS) as z:
        return {k: z[k] for k in z.files}


def _model():
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    return build_model(cfg, device="cpu")


def test_every_key_is_consumed_and_every_tensor_set(flat):
    model = _model()
    assert load_npz(model, WEIGHTS) == len(flat) == 272
    state = model.state_dict()
    assert {npz_key(k) for k in state} == set(flat)
    for k, v in state.items():
        np.testing.assert_array_equal(v.numpy(),
                                      flat[npz_key(k)].astype(np.float32))


def test_missing_key_raises_and_leaves_model_unchanged(flat):
    model = _model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    partial = dict(flat)
    partial.pop("params/rpn/cls_head/Dense_0/kernel")
    with pytest.raises(RuntimeError, match="missing"):
        load_flat(model, partial)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_shape_mismatch_raises(flat):
    bad = dict(flat)
    key = "params/rcnn/xyz_up/Dense_0/kernel"
    bad[key] = np.zeros((4, 128), np.float16)
    with pytest.raises(RuntimeError, match="mismatched"):
        load_flat(_model(), bad)


def test_unused_key_raises(flat):
    extra = dict(flat)
    extra["params/rpn/not_a_layer/kernel"] = np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="unused"):
        load_flat(_model(), extra)


def test_key_mapping():
    assert npz_key("rpn.backbone.sa_0.mlp_0.Dense_0.kernel") == \
        "params/rpn/backbone/sa_0/mlp_0/Dense_0/kernel"
    assert npz_key("rpn.cls_head.BatchNorm_0.var") == \
        "batch_stats/rpn/cls_head/BatchNorm_0/var"
