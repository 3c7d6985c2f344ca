"""The stage-2 entry point on the CPU: two steps of
`python -m ws3d_tpu_torch.tools.train_cascade` for the RCNN stage, then two
IOUN steps warmed from its checkpoint, with finite losses, the files each
writes, the IOUN trunk equal to the RCNN checkpoint's, and port-trained
stage-2 weights that load into the JAX package. Also the Trainer pieces the
CLI uses and the ball query's dispatch."""
import math
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_helpers import REPO, stage2_cfg, t
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.training import Trainer, load_part_checkpoint
from ws3d_tpu_torch.training.trainer import trainable_parameters
from ws3d_tpu_torch.weights import save_npz


def _run(stage, out, *extra):
    res = subprocess.run(
        [sys.executable, "-m", "ws3d_tpu_torch.tools.train_cascade",
         "--stage", stage, "--synthetic", "--steps", "2", "--batch", "8",
         "--npoints", "128", "--db_size", "16", "--device", "cpu",
         "--output_dir", str(out), *extra],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    losses = [float(v) for v in re.findall(r" loss=([-\w.]+)", res.stderr)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert "no BatchNorm: nothing to recalibrate" in res.stderr
    return res.stderr


def test_cli_trains_both_stages(tmp_path):
    _run("rcnn", tmp_path / "rcnn")
    for name in ("rcnn_ckpt.pt", "rcnn_weights.npz", "log.txt"):
        assert (tmp_path / "rcnn" / name).exists(), name
    log = _run("cascade_later", tmp_path / "ioun", "--ckpt",
               str(tmp_path / "rcnn" / "rcnn_ckpt.pt"))
    rcnn = torch.load(tmp_path / "rcnn" / "rcnn_ckpt.pt",
                      weights_only=True)
    ioun = torch.load(tmp_path / "ioun" / "ioun_ckpt.pt",
                      weights_only=True)
    assert f"loaded {len(rcnn['model'])} rcnn tensors" in log
    assert ioun["step"] == 2
    for k, v in rcnn["model"].items():         # the frozen, warmed trunk
        assert torch.equal(ioun["model"][k], v), k
    assert set(ioun["optimizer"]["mu"]) == set(
        trainable_parameters(_model("ioun"), "ioun"))


def _model(stage):
    return build_model(stage2_cfg(load_config, stage), device="cpu")


def test_part_checkpoint_from_npz_keeps_missing_entries(tmp_path):
    src = _model("rcnn")
    with torch.no_grad():
        for p in src.parameters():
            p.add_(1.0)
    save_npz(src, str(tmp_path / "w.npz"))
    dst = _model("ioun")
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    assert load_part_checkpoint(dst, str(tmp_path / "w.npz"),
                                subtrees=("rcnn",)) == len(src.state_dict())
    for k, v in dst.state_dict().items():
        ref = src.state_dict().get(k, before[k])
        assert torch.equal(v, ref), k
    assert load_part_checkpoint(dst, str(tmp_path / "w.npz"),
                                subtrees=("rpn",)) == 0


def test_port_trained_stage2_weights_load_into_jax(tmp_path):
    import jax
    from ws3d_tpu.config import load_config as jax_config
    from ws3d_tpu.models import build_model as jax_build
    from ws3d_tpu.models import init_model
    from ws3d_tpu.utils.npz_overlay import overlay_flat_npz
    model = _model("ioun")
    path = str(tmp_path / "w.npz")
    save_npz(model, path)
    jcfg = stage2_cfg(jax_config, "ioun")
    jmodel = jax_build(jcfg)
    variables = init_model(jmodel, jcfg, jax.random.PRNGKey(0))
    _, n_set, n_all = overlay_flat_npz(variables, path)
    assert n_set == n_all == len(model.state_dict())


def test_trainer_pieces():
    from ws3d_tpu.training.trainer import Trainer as JaxTrainer
    for e, total in ((0, 10), (3, 10), (9, 10), (0, 1)):
        assert Trainer.prob_mask_ratio(e, total) == \
            JaxTrainer.prob_mask_ratio(None, e, total)
    model = _model("ioun")
    trainer = Trainer(model, stage2_cfg(load_config, "ioun"),
                      total_steps=4, stage="ioun", log_fn=lambda s: 0)
    assert trainer.recalibrate_bn(iter([])) == 0
    names = set(trainer.optimizer.params)
    assert names and all(k.split(".")[1].startswith(("can_", "sa_score_",
                                                      "iou_head_",
                                                      "icl_head_",
                                                      "ref_head_"))
                         for k in names)
    with pytest.raises(ValueError):
        trainable_parameters(model, "rpn2")


def test_ball_query_dispatches_on_the_device(rng):
    from ws3d_tpu_torch.ops import ball_query as bq
    from ws3d_tpu_torch.ops.grouping import ball_query
    xyz = rng.randn(2, 256, 3).astype(np.float32)
    new_xyz = xyz[:, :32].copy()
    got = ball_query(0.6, 8, t(xyz), t(new_xyz), chunk=8)
    ref = bq.ball_query_multi_plain([0.6], [8], t(xyz), t(new_xyz))[0]
    assert got.dtype == torch.int32 and torch.equal(got, ref)
