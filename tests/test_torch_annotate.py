"""The annotation tool, the stage-2 aliases and the GPU self-test on the
CPU: annotate --headless --to_noise of both packages on a KITTI tree
written by write_kitti_tree and on the synthetic generator must write
byte-identical label_w/label.txt and label_noise/ files; train_cascade1 and
train_cascade_later hand train_cascade their arguments with --stage rcnn
and --stage ioun; gpu_selftest raises without a CUDA device and has no CPU
run."""
import os
import sys

import pytest
import torch

from torch_port_helpers import REPO
from ws3d_tpu_torch.tools import (annotate, gpu_selftest, train_cascade,
                                  train_cascade1, train_cascade_later)

sys.path.insert(0, os.path.join(REPO, "tools"))
SCENES = 3


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from ws3d_tpu_torch.datasets import SyntheticKitti
    from ws3d_tpu_torch.datasets.kitti_io import write_kitti_tree
    root = tmp_path_factory.mktemp("kitti")
    src = SyntheticKitti(num_scenes=SCENES, points_per_scene=4000, seed=5)
    write_kitti_tree(str(root), [src.get_scene(i) for i in src.sample_ids])
    return str(root)


def _files(d):
    out = {}
    for base, _, names in os.walk(d):
        for name in names:
            if name.endswith(".txt") and name != "log.txt":
                path = os.path.join(base, name)
                out[os.path.relpath(path, d)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("source", ["tree", "synthetic"])
def test_headless_labels_match_jax(tree, tmp_path, monkeypatch, source):
    import annotate as jax_tool
    args = ["--headless", "--to_noise", "--scenes", str(SCENES),
            "--seed", "2"]
    args += ["--data_root", tree] if source == "tree" else ["--synthetic"]
    monkeypatch.setattr(sys, "argv", ["annotate.py", "--output_dir",
                                      str(tmp_path / "jax")] + args)
    jax_tool.main()
    assert annotate.main(args + ["--output_dir", str(tmp_path / "port")]) \
        == 0
    ref, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == sorted(ref)
    assert "label_w/label.txt" in got
    assert len([k for k in got if k.startswith("label_noise")]) == SCENES
    assert got["label_w/label.txt"].count(b"\n") > 0
    for k in ref:
        assert got[k] == ref[k], k


def test_session_and_projection_match_jax(rng, tmp_path):
    import annotate as jax_tool
    gts = rng.uniform(-20, 20, (4, 7))
    sessions = [annotate.AnnotationSession(str(tmp_path / "p")),
                jax_tool.AnnotationSession(str(tmp_path / "j"))]
    clicks = gts[rng.randint(4, size=20)][:, [0, 2]] + rng.uniform(
        -4, 4, (20, 2))                    # within 3 m of a centre or not
    for x, z in clicks:
        recs = [s.click(7, float(x), float(z), gts) for s in sessions]
        assert recs[0] == recs[1]
    n_kept = [s.flush() for s in sessions]
    assert n_kept[0] == n_kept[1] > 0
    assert open(tmp_path / "p" / "label.txt").read() == \
        open(tmp_path / "j" / "label.txt").read()
    assert sessions[0].click(1, 0.0, 0.0, gts[:0]) is None
    uv = rng.uniform(0, 1000, (300, 2))
    for x, y in rng.uniform(0, 1000, (10, 2)):
        assert annotate.nearest_projected_point(uv, x, y) == \
            jax_tool.nearest_projected_point(uv, x, y)


@pytest.mark.parametrize("alias,stage", [(train_cascade1, "rcnn"),
                                         (train_cascade_later, "ioun")])
def test_cascade_aliases_pass_the_stage(monkeypatch, alias, stage):
    seen = []
    monkeypatch.setattr(train_cascade, "main",
                        lambda argv=None: seen.append(argv) or 0)
    assert alias.main(["--synthetic", "--steps", "1"]) == 0
    assert seen == [["--synthetic", "--steps", "1", "--stage", stage]]
    monkeypatch.setattr(sys, "argv", ["x", "--cpu"])
    assert alias.main() == 0
    assert seen[-1] == ["--cpu", "--stage", stage]


def test_gpu_selftest_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gpu_selftest.run()
    with pytest.raises(RuntimeError, match="CUDA"):
        gpu_selftest.main([])
