"""ws3d_tpu_torch.tools.bench_train, the port's counterpart of
tools/bench_train.py, on the CPU at small sizes.

- --reps below 2 is refused, as the JAX tool refuses it;
- the step the bench times gives the JAX step's loss within 1e-4 relative
  from the same variables (the JAX package's init_model, carried in by
  weights.load_variables) on the bench's own batch, DP_RATIO 0 on both
  sides: stage 1 at 2 scenes of 2,048 points, RCNN at 8 crops of 128;
- fwd_ms + bwd_ms + optimizer_ms equals device_ms_per_step within the
  rounding of the three (CPU seconds here: the arithmetic, not a device
  time), and the forward-only loop's forward launches what the step's
  does (on CPU tensors nothing launches; the card's run checks counts);
- several stages run one subprocess a stage (subprocess.run patched);
- the tool has no CPU mode."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ws3d_tpu_torch.tools import bench_train as bt
from ws3d_tpu_torch.weights import load_variables


def test_reps_below_two_refused(capsys):
    with pytest.raises(SystemExit):
        bt.parse_args(["--reps", "1"])
    assert "--reps must be >= 2" in capsys.readouterr().err
    assert bt.parse_args(["--reps", "2"]).reps == 2


def _rpn_cfg(load_config):
    cfg = load_config()
    cfg.RPN.NUM_POINTS = 2048
    cfg.RPN.SA_CONFIG.NPOINTS = [512, 128, 32, 8]
    cfg.RPN.DP_RATIO = 0.0
    return cfg


def _rcnn_cfg(stage2_config):
    cfg = stage2_config("rcnn", 128)
    cfg.RCNN.SA_CONFIG.NPOINTS = [64, 32, 8, -1]   # train_cascade's scaling
    cfg.RCNN.DP_RATIO = 0.0
    return cfg


def _jax_rcnn_cfg():
    from ws3d_tpu.config import load_config

    def stage2_config(stage, points):
        cfg = load_config()
        cfg.RPN.ENABLED = False
        cfg.RCNN.ENABLED = True
        cfg.IOUN.ENABLED = stage == "ioun"
        cfg.RCNN.NUM_POINTS = points
        return cfg
    return _rcnn_cfg(stage2_config)


def _jax_step_loss(jcfg, host_batch, stage: str, bench):
    """The JAX tool's step (create_train_state, make_*_train_step) from
    init_model's variables on `host_batch`; loads the same variables into
    the port's bench model. Returns the JAX step's loss."""
    from ws3d_tpu.models import build_model, init_model
    from ws3d_tpu.training import create_train_state
    from ws3d_tpu.training.trainer import (make_rcnn_train_step,
                                           make_rpn_train_step)
    model = build_model(jcfg)
    variables = init_model(model, jcfg, jax.random.PRNGKey(0))
    assert load_variables(bench.model, variables) == len(
        bench.model.state_dict())
    state = create_train_state(model, jcfg, variables, total_steps=1000,
                               stage=stage)
    step = (make_rpn_train_step(model, jcfg) if stage == "rpn"
            else make_rcnn_train_step(model, jcfg, stage=stage))
    keys = bench.batch.keys()
    _, aux = jax.jit(step)(state, {k: jnp.asarray(host_batch[k])
                                   for k in keys},
                           jax.random.PRNGKey(1), 0.1)
    return float(aux["loss"])


def test_rpn_step_loss_matches_jax():
    from ws3d_tpu.config import load_config as jax_config
    from ws3d_tpu_torch.config import load_config
    b = bt.rpn_bench(_rpn_cfg(load_config), 2, "cpu")
    assert b.batch["pts_input"].shape == (2, 2048, 4)
    ref = _jax_step_loss(_rpn_cfg(jax_config), b.host_batch, "rpn", b)
    got = float(b.step(b.batch, b.generator, bt.BN_MOMENTUM)["loss"])
    assert np.isfinite(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


@pytest.fixture(scope="module")
def rcnn():
    return bt.stage2_bench(_rcnn_cfg(bt.stage2_config), "rcnn", 8, 128,
                           "cpu")


def test_rcnn_step_loss_matches_jax(rcnn):
    b = rcnn
    assert b.batch["cur_box_point"].shape == (8, 128, 3)
    ref = _jax_step_loss(_jax_rcnn_cfg(), b.host_batch, "rcnn", b)
    got = float(b.step(b.batch, b.generator, bt.BN_MOMENTUM)["loss"])
    assert np.isfinite(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_split_adds_up(rcnn):
    assert bt.forward_launches(rcnn) == {}
    sec, res = bt.timings(rcnn, 2, split=True)
    assert sec > 0 and res["steps_per_sec"] > 0
    parts = res["fwd_ms"] + res["bwd_ms"] + res["optimizer_ms"]
    # three values rounded to 0.01 ms against one
    assert abs(parts - res["device_ms_per_step"]) <= 0.02
    assert set(res) == {"device_ms_per_step", "steps_per_sec", "fwd_ms",
                        "bwd_ms", "optimizer_ms"}


def test_one_subprocess_a_stage(monkeypatch):
    calls = []
    monkeypatch.setattr(bt.subprocess, "run",
                        lambda cmd, **kw: calls.append((cmd, kw)))
    assert bt.main(["--stages", "rpn,rcnn,ioun", "--reps", "3",
                    "--split"]) == 0
    assert [c[0][c[0].index("--stages") + 1] for c in calls] == \
        ["rpn", "rcnn", "ioun"]
    for cmd, kw in calls:
        assert cmd[:3] == [sys.executable, "-m",
                           "ws3d_tpu_torch.tools.bench_train"]
        assert cmd[5:] == ["--reps", "3", "--rpn_batch", "25",
                           "--stage2_batch", "800", "--stage2_points", "512",
                           "--split"]
        assert kw == {"check": True, "cwd": bt.ROOT}


def test_no_cpu_mode(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.main(["--stages", "rcnn"])
