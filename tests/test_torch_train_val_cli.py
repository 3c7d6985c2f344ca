"""The training CLIs with in-training validation, the port's against the
JAX package's at a small size on the CPU: train_rpn (--val_scenes,
--val_every) and train_cascade --stage rcnn (--val_ratio, --val_every) log
the same step and val keys, run the same number of evals at the same
steps, log a `best val:` line, and the port writes a checkpoint per eval,
the best one and tb/scalars.jsonl. fit_bench_weights refuses an --out
inside ws3d_tpu/, runs the JAX tool's four tools in order, and turns the
checkpoints of small runs into weights the JAX package loads."""
import json
import os
import re
import subprocess
import sys

import pytest

from torch_port_helpers import REPO

ENV = {"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}


def _run(args, out_dir):
    res = subprocess.run([sys.executable, *args, "--output_dir", str(out_dir)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, **ENV))
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stderr


def _parse(log):
    """(step keys, [(step, val keys)], best-val line present)."""
    steps = [set(re.findall(r"(\w+)=", line.split(":", 1)[1]))
             for line in re.findall(r" step \d+: [^\n]*", log)]
    vals = [(int(s), set(re.findall(r"([\w.]+)=", rest)))
            for s, rest in re.findall(r"val @ step (\d+): ([^\n]*)", log)]
    return steps, vals, "best val:" in log


def _compare(jax_log, port_log):
    jsteps, jvals, jbest = _parse(jax_log)
    tsteps, tvals, tbest = _parse(port_log)
    assert jsteps and tsteps == jsteps
    assert jvals and tvals == jvals
    assert jbest and tbest
    return tvals


def _check_outputs(out, stage, n_eval):
    for k in range(1, n_eval + 1):
        assert (out / f"{stage}_ckpt_e{k}.pt").exists(), k
    assert not (out / f"{stage}_ckpt_e{n_eval + 1}.pt").exists()
    assert (out / f"{stage}_ckpt_best.pt").exists()
    recs = [json.loads(line) for line in open(out / "tb" / "scalars.jsonl")]
    assert sum("val/score" in r for r in recs) == n_eval
    assert any("loss" in r for r in recs)


def test_train_rpn_validates_as_the_jax_tool(tmp_path):
    common = ["--synthetic", "--steps", "3", "--batch", "2", "--points",
              "2048", "--scenes", "4", "--val_scenes", "2", "--val_every",
              "2"]
    jax_log = _run(["tools/train_rpn.py", *common, "--cpu"], tmp_path / "j")
    port_log = _run(["-m", "ws3d_tpu_torch.tools.train_rpn", *common,
                     "--device", "cpu"], tmp_path / "t")
    vals = _compare(jax_log, port_log)
    assert [s for s, _ in vals] == [1, 2]
    assert {"vote_precision", "gt_recall", "score"} <= vals[0][1]
    assert "in-training val: 2 scenes" in port_log
    _check_outputs(tmp_path / "t", "rpn", 2)


def test_train_cascade_validates_as_the_jax_tool(tmp_path):
    common = ["--stage", "rcnn", "--synthetic", "--steps", "3", "--batch",
              "8", "--npoints", "128", "--db_size", "16", "--val_ratio",
              "0.25", "--val_every", "2"]
    jax_log = _run(["tools/train_cascade.py", *common, "--cpu"],
                   tmp_path / "j")
    port_log = _run(["-m", "ws3d_tpu_torch.tools.train_cascade", *common,
                     "--device", "cpu"], tmp_path / "t")
    vals = _compare(jax_log, port_log)
    assert [s for s, _ in vals] == [1, 2]
    assert {"recall_0.5", "recall_0.7", "iou_mean", "score"} <= vals[0][1]
    # 4 of the 16 records held out, as the JAX tool holds them out
    for log in (jax_log, port_log):
        assert "in-training val: 4 held-out crops" in log
        assert "stage-2 dataset: 48 samples" in log
    _check_outputs(tmp_path / "t", "rcnn", 2)


def test_train_cascade_split_matches_jax():
    import numpy as np
    from ws3d_tpu_torch.tools.train_cascade import split_database
    db = list(range(40))
    train, val = split_database(db, 0.1)
    order = np.random.RandomState(666).permutation(40)
    assert val == [int(i) for i in order[:4]]
    assert train == [int(i) for i in order[4:]]
    assert split_database(db[:7], 0.1) == (db[:7], [])
    assert split_database(db, 0.0) == (db, [])
    assert len(split_database(db[:8], 0.1)[1]) == 2


@pytest.mark.parametrize("out", ["ws3d_tpu/data/bench_weights.npz",
                                 "ws3d_tpu/new.npz",
                                 "ws3d_tpu_torch/../ws3d_tpu/data/w.npz"])
def test_fit_bench_weights_refuses_the_jax_package(out):
    res = subprocess.run(
        [sys.executable, "-m", "ws3d_tpu_torch.tools.fit_bench_weights",
         "--out", out, "--rpn_steps", "1", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "refusing to write inside" in res.stderr
    assert not os.path.exists(os.path.join(REPO, "ws3d_tpu", "new.npz"))


def test_fit_bench_weights_runs_the_jax_flow(tmp_path, monkeypatch):
    """The four tools in the JAX tool's order, at their own default sizes,
    each stage's checkpoint and the database passed on; then convert()
    on the RPN and IOUN checkpoints."""
    from ws3d_tpu_torch.tools import fit_bench_weights as fbw
    calls = []
    monkeypatch.setattr(fbw, "run", lambda tool, argv: calls.append(
        (tool.__name__.rsplit(".", 1)[1], argv)))
    monkeypatch.setattr(fbw, "convert", lambda *a: calls.append(
        ("convert", list(a))))
    out = tmp_path / "w.npz"
    wd = str(tmp_path / "wd")
    assert fbw.main(["--out", str(out), "--rpn_steps", "3", "--rcnn_steps",
                     "4", "--ioun_steps", "5", "--scenes", "6", "--batch",
                     "2", "--workdir", wd, "--device", "cpu"]) == 0
    db = os.path.join(wd, "train_boxes.pkl")
    assert calls == [
        ("train_rpn", ["--synthetic", "--steps", "3", "--batch", "2",
                       "--scenes", "6", "--output_dir", wd, "--device",
                       "cpu"]),
        ("generate_box_dataset", ["--synthetic", "--ckpt",
                                  os.path.join(wd, "rpn_ckpt.pt"),
                                  "--scenes", "6", "--output_dir", wd,
                                  "--out", db, "--device", "cpu"]),
        ("train_cascade", ["--stage", "rcnn", "--synthetic", "--steps", "4",
                           "--db", db, "--output_dir", wd, "--device",
                           "cpu"]),
        ("train_cascade", ["--stage", "ioun", "--synthetic", "--steps", "5",
                           "--db", db, "--ckpt",
                           os.path.join(wd, "rcnn_ckpt.pt"), "--output_dir",
                           wd, "--device", "cpu"]),
        ("convert", [os.path.join(wd, "rpn_ckpt.pt"),
                     os.path.join(wd, "ioun_ckpt.pt"), str(out), "cpu"])]


def test_fit_bench_weights_writes_weights_jax_loads(tmp_path):
    """--from_ckpts on the checkpoints of small train_rpn and train_cascade
    --stage ioun runs: every array of the JAX two-stage tree is set, the
    rpn entries from the RPN checkpoint and the rcnn ones from the IOUN
    checkpoint."""
    import jax
    import numpy as np
    from ws3d_tpu.config import load_config
    from ws3d_tpu.models import build_model, init_model
    from ws3d_tpu.utils.npz_overlay import overlay_flat_npz
    from ws3d_tpu_torch.tools import fit_bench_weights, train_cascade, \
        train_rpn
    wd = str(tmp_path / "wd")
    assert train_rpn.main(["--synthetic", "--steps", "1", "--batch", "2",
                           "--points", "2048", "--scenes", "2",
                           "--val_scenes", "0", "--output_dir", wd,
                           "--device", "cpu"]) == 0
    assert train_cascade.main(["--stage", "ioun", "--synthetic", "--steps",
                               "1", "--batch", "8", "--npoints", "128",
                               "--db_size", "8", "--val_ratio", "0",
                               "--output_dir", wd, "--device", "cpu"]) == 0
    out = tmp_path / "w" / "weights.npz"
    rpn_ckpt = os.path.join(wd, "rpn_ckpt.pt")
    ioun_ckpt = os.path.join(wd, "ioun_ckpt.pt")
    assert fit_bench_weights.main(["--out", str(out), "--from_ckpts",
                                   rpn_ckpt, ioun_ckpt, "--device",
                                   "cpu"]) == 0
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    model = build_model(cfg)
    variables = init_model(model, cfg, jax.random.PRNGKey(0))
    _, n_set, n_all = overlay_flat_npz(variables, str(out))
    assert n_set == n_all
    # the npz holds each checkpoint's own tensors: an rpn tensor differs
    # between the two checkpoints and the npz takes the RPN checkpoint's
    from ws3d_tpu_torch.config import load_config as torch_load_config
    from ws3d_tpu_torch.models import build_model as torch_build_model
    from ws3d_tpu_torch.training import load_part_checkpoint
    from ws3d_tpu_torch.weights import save_npz
    for ckpt, subtrees in ((rpn_ckpt, ("rpn",)), (ioun_ckpt, ("rcnn",))):
        tcfg = torch_load_config()
        tcfg.RCNN.ENABLED = True
        tcfg.IOUN.ENABLED = True
        ref = torch_build_model(tcfg, device="cpu")
        load_part_checkpoint(ref, ckpt, subtrees=subtrees)
        ref_path = tmp_path / f"{subtrees[0]}.npz"
        save_npz(ref, str(ref_path))
        with np.load(out) as got, np.load(ref_path) as want:
            keys = [k for k in want.files if f"/{subtrees[0]}/" in f"/{k}"]
            assert keys
            for k in keys:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
