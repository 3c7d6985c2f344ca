"""The checkpoint sweep of the port (ws3d_tpu_torch/tools/eval_all_ckpt.py)
held against tools/eval_all_ckpt.py on the same two train states: the first
holds the fitted weights, the second the same with the RCNN cls head's last
bias at -50 (no crop passes the score gate, so it detects nothing). The port
gets them as the Trainer writes them at its validations (rcnn_ckpt_e1.pt,
rcnn_ckpt_e2.pt), the JAX tool as orbax checkpoints of the same names.
Both tools sweep 2 synthetic scenes of 4,096 points on the CPU (SA NPOINTS
1024/256/64/16, K = 8): the same checkpoints are scored, each summed Car 3D
AP agrees within 3e-4 (test_torch_eval_auto's 1e-4 a class and level, three
levels summed), the same checkpoint is the best, and ckpt_sweep.json has the
same record. --subprocess (one eval_auto process a checkpoint) gives the
in-process scores to the AP line's two decimals; other files in the
directory are not swept."""
import copy
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from torch_port_helpers import REPO, WEIGHTS, jax_detector
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.tools import eval_all_ckpt
from ws3d_tpu_torch.tools.eval_auto import configure
from ws3d_tpu_torch.training import Trainer
from ws3d_tpu_torch.weights import load_npz

sys.path.insert(0, os.path.join(REPO, "tools"))

AP_TOL = 3e-4
ARGS = ["--synthetic", "--scenes", "2", "--points", "4096", "--cpu",
        "--set", "TPU.MAX_PROPOSALS=8", "RPN.SA_CONFIG.NPOINTS=[1024,256,64,16]"]
DEAD_BIAS = -50.0


def _port_ckpts(d):
    cfg = load_config()
    configure(cfg, 4096)
    model = build_model(cfg, device="cpu")
    load_npz(model, WEIGHTS)
    trainer = Trainer(model, cfg, total_steps=2, stage="rcnn",
                      log_fn=lambda s: None)
    scores = iter([0.5, 0.1])
    trainer._run_validation(lambda m: {"score": next(scores)}, 0, 1, str(d))
    with torch.no_grad():
        head = model.rcnn.cls_head
        getattr(head, f"Dense_{head.n_hidden}").bias.fill_(DEAD_BIAS)
    trainer._run_validation(lambda m: {"score": next(scores)}, 1, 2, str(d))
    (d / "resume_step_1.pt").write_bytes(b"")      # not a sweep checkpoint


def _jax_ckpts(d):
    import jax
    from ws3d_tpu.training.checkpoint import save_checkpoint
    _, variables, _ = jax_detector()
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    dead = copy.deepcopy(params)
    head = dead["rcnn"]["cls_head"]
    last = max((k for k in head if k.startswith("Dense_")),
               key=lambda k: int(k.split("_")[1]))
    head[last]["bias"] = np.full_like(head[last]["bias"], DEAD_BIAS)
    for name, p in (("rcnn_ckpt_e1", params), ("rcnn_ckpt_e2", dead)):
        save_checkpoint(str(d / name), types.SimpleNamespace(
            step=np.int32(0), params=p, batch_stats=stats))


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    port, ref = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    _port_ckpts(port)
    _jax_ckpts(ref)
    return port, ref


@pytest.fixture(scope="module")
def sweeps(ckpt_dirs, tmp_path_factory):
    """(JAX summary, port summary, port output dir) of the in-process
    sweeps."""
    import eval_all_ckpt as jax_tool
    port, ref = ckpt_dirs
    out = tmp_path_factory.mktemp("sweeps")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["eval_all_ckpt.py", "--ckpt_dir", str(ref),
                                 "--output_dir", str(out / "jax")] + ARGS)
        jax_tool.main()
    assert eval_all_ckpt.main(["--ckpt_dir", str(port), "--output_dir",
                               str(out / "port")] + ARGS) == 0
    return (json.loads((out / "jax" / "ckpt_sweep.json").read_text()),
            json.loads((out / "port" / "ckpt_sweep.json").read_text()),
            out / "port")


def _stem(path):
    return os.path.splitext(os.path.basename(path))[0]


def test_find_checkpoints_orders_by_stage_and_eval(tmp_path):
    for name in ("rcnn_ckpt_e10.pt", "rcnn_ckpt_e2.pt", "rpn_ckpt_e1.pt",
                 "rcnn_ckpt_best.pt", "rcnn_ckpt.pt", "x_ckpt_e1.pt.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert [os.path.basename(p) for p in eval_all_ckpt.find_checkpoints(
        str(tmp_path))] == ["rcnn_ckpt_e2.pt", "rcnn_ckpt_e10.pt",
                            "rpn_ckpt_e1.pt"]


def test_sweep_in_process_picks_the_best(sweeps):
    ref, got, out = sweeps
    assert got.keys() == ref.keys() == {"results", "best"}
    assert [_stem(r["ckpt"]) for r in got["results"]] == [
        _stem(r["ckpt"]) for r in ref["results"]] == ["rcnn_ckpt_e1",
                                                      "rcnn_ckpt_e2"]
    for r, g in zip(ref["results"], got["results"]):
        assert g.keys() == r.keys()
        assert g["sum_3d_ap"] == pytest.approx(r["sum_3d_ap"], abs=AP_TOL)
    s1, s2 = (r["sum_3d_ap"] for r in got["results"])
    assert s2 == 0.0 < s1
    assert _stem(got["best"]["ckpt"]) == _stem(ref["best"]["ckpt"]) \
        == "rcnn_ckpt_e1"
    assert got["best"]["sum_3d_ap"] == s1
    assert (out / "rcnn_ckpt_e1" / "final_result" / "data").is_dir()


def test_sweep_in_subprocesses_gives_the_same_scores(ckpt_dirs, sweeps,
                                                     tmp_path):
    _, inproc, _ = sweeps
    assert eval_all_ckpt.main(["--ckpt_dir", str(ckpt_dirs[0]),
                               "--output_dir", str(tmp_path)] + ARGS
                              + ["--subprocess"]) == 0
    sub = json.loads((tmp_path / "ckpt_sweep.json").read_text())
    for x, y in zip(inproc["results"], sub["results"]):
        assert x["ckpt"] == y["ckpt"]
        assert y["sum_3d_ap"] == pytest.approx(x["sum_3d_ap"], abs=0.015)
    assert inproc["best"]["ckpt"] == sub["best"]["ckpt"]
