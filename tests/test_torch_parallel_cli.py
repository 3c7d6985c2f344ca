"""The tools' --mesh on the CPU (two gloo ranks): train_rpn takes two
data-parallel steps with finite losses and only rank 0 writes; eval_auto
--mesh 2 writes the txt files of --mesh 0 at the default K (the stage-2
budget pooled over the whole batch, as in one process); a batch the mesh
does not divide is refused; the tools set no deadline for a whole run,
and a CUDA launch builds the kernels once before its ranks start."""
import json
import os
import re

import numpy as np
import pytest

from ws3d_tpu_torch.tools import eval_auto, train_rpn


def test_train_rpn_mesh_2_on_the_cpu(tmp_path):
    assert train_rpn.main(["--synthetic", "--steps", "2", "--batch", "2",
                           "--points", "512", "--scenes", "4",
                           "--val_scenes", "2", "--val_every", "1",
                           "--mesh", "2", "--cpu",
                           "--output_dir", str(tmp_path)]) == 0
    log = (tmp_path / "log.txt").read_text()
    assert "data parallel over 2 ranks (gloo), 1 scenes a rank" in log
    losses = [float(v) for v in re.findall(r"step \d+: loss=(\S+)", log)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    # rank 0 alone logs, validates and writes: one record a step and an
    # eval, one checkpoint an eval (the other rank waits at a barrier)
    rows = [json.loads(line) for line in
            (tmp_path / "tb" / "scalars.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 0, 1, 1]
    assert log.count("val @ step") == 2
    assert log.count("saved checkpoint") == 1
    assert {"rpn_ckpt.pt", "rpn_weights.npz", "rpn_ckpt_e1.pt",
            "rpn_ckpt_e2.pt", "rpn_ckpt_best.pt"} <= set(
        os.listdir(tmp_path))


def _rows(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = np.array([[float(v) for v in line.split()[1:]]
                                  for line in f if line.split()],
                                 np.float64).reshape(-1, 15)
    return out


@pytest.mark.parametrize("budget", [[], ["--set",
                                         "TPU.IOUN_BUDGET_PER_SCENE=2"]],
                         ids=["default", "cascade_pool_spills"])
def test_eval_auto_mesh_2_equals_mesh_0(tmp_path, budget):
    """At the default K and budgets, and with a cascade pool of 8 slots for
    the batch (one of 8 a rank would hold 16)."""
    args = ["--synthetic", "--scenes", "2", "--points", "4096",
            "--bench_weights", "--batch", "2", "--cpu"] + budget + [
            "--output_dir"]
    assert eval_auto.main(args + [str(tmp_path / "m0")]) == 0
    assert eval_auto.main(args + [str(tmp_path / "m2"), "--mesh", "2"]) == 0
    a = _rows(tmp_path / "m0" / "final_result" / "data")
    b = _rows(tmp_path / "m2" / "final_result" / "data")
    assert sorted(a) == sorted(b) == ["000000.txt", "000001.txt"]
    assert sum(len(v) for v in a.values()) > 0
    for name in a:
        assert a[name].shape == b[name].shape, name
        np.testing.assert_allclose(b[name], a[name], atol=1e-4, err_msg=name)
    log = (tmp_path / "m2" / "log.txt").read_text()
    assert "Car 3D AP e/m/h" in log


@pytest.mark.parametrize("tool", [eval_auto, train_rpn])
def test_mesh_must_divide_the_batch(tool, tmp_path):
    with pytest.raises(SystemExit, match="divisible by --mesh"):
        tool.main(["--synthetic", "--batch", "3", "--mesh", "2", "--cpu",
                   "--output_dir", str(tmp_path)])


def test_the_tools_set_no_run_deadline(monkeypatch):
    """--mesh outside torchrun launches its ranks with no deadline for the
    whole run: a training or eval run outlasts any fixed limit, and a hung
    collective fails on the group's timeout instead."""
    import argparse
    import ws3d_tpu_torch.parallel as parallel
    calls = []
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(parallel, "launch",
                        lambda *a, **kw: calls.append((a, kw)) or [0])
    args = argparse.Namespace(mesh=2, cpu=True, device=None)
    assert train_rpn.run_ranks(args, eval_auto._run) == 0
    (a, kw), = calls
    assert a[1] == 2 and kw == {"device": "cpu", "timeout": None}


def test_launch_builds_the_kernels_once_before_the_ranks(monkeypatch):
    """On CUDA, launch builds the kernels in the parent before it starts a
    rank, so N ranks do not run N builds."""
    import ws3d_tpu_torch.parallel as parallel
    from ws3d_tpu_torch.ops import _kernels

    class Built(Exception):
        pass

    def build():
        raise Built

    monkeypatch.setattr(_kernels, "build", build)
    with pytest.raises(Built):
        parallel.launch(print, 2, backend="gloo", device="cuda:0")


def test_train_rpn_under_a_torchrun_environment(tmp_path):
    """RANK/WORLD_SIZE set (as torchrun sets them): the process is one rank
    of the group, and --mesh must equal WORLD_SIZE."""
    import subprocess
    import sys
    from torch_port_helpers import REPO
    from ws3d_tpu_torch.parallel.mesh import free_port
    env = dict(os.environ, RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()))
    args = [sys.executable, "-m", "ws3d_tpu_torch.tools.train_rpn",
            "--synthetic", "--steps", "1", "--batch", "1", "--points", "512",
            "--scenes", "2", "--val_scenes", "0", "--cpu"]
    res = subprocess.run(args + ["--mesh", "1", "--output_dir",
                                 str(tmp_path / "ok")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    log = (tmp_path / "ok" / "log.txt").read_text()
    assert "data parallel over 1 ranks (gloo)" in log
    res = subprocess.run(args + ["--mesh", "2", "--batch", "2", "--output_dir",
                                 str(tmp_path / "bad")], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "--mesh 2 under torchrun with WORLD_SIZE 1" in res.stderr
