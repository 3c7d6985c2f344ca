"""The stage-1 entry point and the weights it writes: two CPU steps of
`python -m ws3d_tpu_torch.tools.train_rpn` with a finite loss, a checkpoint
that restores the train state, and port-trained weights that load into the
JAX package (save_npz -> overlay_flat_npz) and give its eval rpn_forward
the port's outputs within the stage-1 tolerance."""
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import REPO, rpn_cfg, rpn_flat_weights, \
    synthetic_batch, train_batch
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.training import (AdamOneCycle, Trainer,
                                     restore_train_state)
from ws3d_tpu_torch.weights import load_flat, save_npz, to_flat

ATOL = 2e-4           # tests/test_torch_stage1.py
RTOL = 1e-4


def test_cli_trains_and_restores(tmp_path):
    out = tmp_path / "out"
    res = subprocess.run(
        [sys.executable, "-m", "ws3d_tpu_torch.tools.train_rpn",
         "--synthetic", "--steps", "2", "--batch", "2", "--points", "2048",
         "--scenes", "4", "--ckpt_every", "1", "--device", "cpu",
         "--output_dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    losses = [float(v) for v in re.findall(r" loss=([-\w.]+)", res.stderr)]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    for name in ("rpn_ckpt.pt", "resume_step_1.pt", "rpn_weights.npz",
                 "log.txt"):
        assert (out / name).exists(), name

    cfg = load_config()
    cfg.RPN.NUM_POINTS = 2048
    cfg.RPN.SA_CONFIG.NPOINTS = [512, 128, 32, 8]
    model = build_model(cfg, device="cpu", seed=1)
    opt = AdamOneCycle(cfg, 2, model.rpn.named_parameters(prefix="rpn"))
    assert restore_train_state(str(out / "rpn_ckpt.pt"), model, opt) == 2
    with np.load(out / "rpn_weights.npz") as z:
        saved = {k: z[k] for k in z.files}
    flat = to_flat(model)
    assert set(flat) == set(saved)
    for k, v in flat.items():
        np.testing.assert_array_equal(v, saved[k], err_msg=k)
    assert all(float(m.abs().max()) > 0 for m in opt.mu.values())
    with pytest.raises(RuntimeError):     # the step must match the moments
        opt.count = 0
        torch.save({"step": 5, "model": model.state_dict(),
                    "optimizer": opt.state_dict()}, tmp_path / "bad.pt")
        restore_train_state(str(tmp_path / "bad.pt"), model, opt)


def test_port_trained_weights_load_into_jax(tmp_path):
    from ws3d_tpu.config import load_config as jax_config
    from ws3d_tpu.models import build_model as jax_build
    from ws3d_tpu.models import init_model
    from ws3d_tpu.utils.npz_overlay import overlay_flat_npz

    cfg = rpn_cfg(load_config)
    model = build_model(cfg, device="cpu")
    load_flat(model, rpn_flat_weights())
    trainer = Trainer(model, cfg, total_steps=10, seed=0, log_fn=lambda s: 0)
    trainer.train_steps([train_batch(2, 2048)], total_steps=1,
                        prefetch_size=0)
    assert trainer.step == 1
    path = str(tmp_path / "w.npz")
    assert save_npz(model, path) == len(rpn_flat_weights())

    jcfg = rpn_cfg(jax_config)
    jmodel = jax_build(jcfg)
    variables = init_model(jmodel, jcfg, jax.random.PRNGKey(0))
    variables, n_set, n_all = overlay_flat_npz(variables, path)
    assert n_set == n_all
    pts = synthetic_batch(2, 2048)
    ref = jax.jit(lambda v, p: jmodel.apply(
        v, {"pts_input": p}, train=False, method=jmodel.rpn_forward))(
        variables, jnp.asarray(pts))
    with torch.no_grad():
        got = model.rpn_forward({"pts_input": torch.from_numpy(pts)})
    for k in ("rpn_cls", "rpn_reg", "backbone_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    assert os.path.getsize(path) > 0
