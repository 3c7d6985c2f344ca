"""The port's twin of tests/test_fixture_drill.py: the whole public flow
through the port's CLIs on a 10-frame KITTI object tree on disk, on the
CPU at tiny shapes: annotate (headless, label_w and the label_noise bridge)
-> train_rpn -> generate_box_dataset -> train_cascade1 ->
train_cascade_later -> eval_auto -> eval_active. It checks the file formats
and the CLI plumbing, not model quality."""
import os
import pickle
import shutil
import subprocess
import sys

import pytest

from torch_port_helpers import REPO


def _run(tool, *args):
    proc = subprocess.run(
        [sys.executable, "-m", f"ws3d_tpu_torch.tools.{tool}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (tool, proc.stdout[-3000:],
                                  proc.stderr[-3000:])
    return proc.stdout + proc.stderr


@pytest.mark.slow
def test_full_public_flow_on_kitti_files(tmp_path):
    from ws3d_tpu_torch.datasets import SyntheticKitti
    from ws3d_tpu_torch.datasets.kitti_io import KittiRaw, write_kitti_tree

    root, out = str(tmp_path / "kitti"), tmp_path / "out"
    src = SyntheticKitti(num_scenes=10, points_per_scene=2500, seed=21,
                         realistic=True)
    scenes = [src.get_scene(i, with_noise=True) for i in range(10)]
    write_kitti_tree(root, scenes, split="train", write_noise=False,
                     extra_splits=[("val", [8, 9]), ("small_val", [8, 9])])
    assert {1, 2, 3} <= {o.level for s in scenes for o in s.labels
                         if o.cls_type == "Car"}

    _run("annotate", "--data_root", root, "--scenes", "10", "--headless",
         "--to_noise", "--output_dir", str(out / "ann"))
    assert os.path.getsize(out / "ann" / "label_w" / "label.txt") > 0
    shutil.copytree(out / "ann" / "label_noise",
                    os.path.join(root, "object", "training", "label_noise"))

    log = _run("train_rpn", "--data_root", root, "--cpu", "--steps", "4",
               "--batch", "2", "--points", "512", "--weakly_num", "8",
               "--val_scenes", "2", "--output_dir", str(out / "rpn"))
    assert "val @ step" in log
    rpn_ckpt = str(out / "rpn" / "rpn_ckpt.pt")
    assert os.path.isfile(rpn_ckpt)

    log = _run("generate_box_dataset", "--data_root", root, "--cpu",
               "--scenes", "6", "--points", "1024", "--ckpt", rpn_ckpt,
               "--score_thresh", "0.005", "--out", str(out / "boxes.pkl"),
               "--output_dir", str(out / "gen"))
    assert "wrote" in log
    with open(out / "boxes.pkl", "rb") as f:
        db = pickle.load(f)
    assert len(db) > 0
    assert {"cur_box_point", "cur_prob_mask", "gt_mask",
            "foreground_flag"} <= set(db[0])

    stage2 = ["--db", str(out / "boxes.pkl"), "--cpu", "--steps", "4",
              "--batch", "4", "--npoints", "128", "--val_ratio", "0"]
    _run("train_cascade1", *stage2, "--output_dir", str(out / "rcnn"))
    rcnn_ckpt = str(out / "rcnn" / "rcnn_ckpt.pt")
    assert os.path.isfile(rcnn_ckpt)
    _run("train_cascade_later", *stage2, "--ckpt", rcnn_ckpt,
         "--output_dir", str(out / "ioun"))
    ioun_ckpt = str(out / "ioun" / "ioun_ckpt.pt")
    assert os.path.isfile(ioun_ckpt)

    log = _run("eval_auto", "--data_root", root, "--cpu", "--scenes", "3",
               "--points", "512", "--ckpt", ioun_ckpt, "--rpn_ckpt",
               rpn_ckpt, "--output_dir", str(out / "eval"))
    assert "Car 3D AP e/m/h" in log and "total bbox recall" in log
    txts = sorted(os.listdir(out / "eval" / "final_result" / "data"))
    assert len(txts) == 3 and txts[0].endswith(".txt")

    log = _run("eval_active", "--data_root", root, "--cpu", "--scenes", "3",
               "--max_points", "1024", "--batch", "2", "--ckpt", ioun_ckpt,
               "--output_dir", str(out / "active"))
    assert "scenes (" in log and "total bbox recall" in log
    assert "3d   AP" in log
    assert len(os.listdir(out / "active" / "final_result" / "data")) == 3

    noise = KittiRaw(root, split="train").get_scene(
        0, with_noise=True).noise_labels
    assert noise and all(o.cls_type == "Car" for o in noise)
