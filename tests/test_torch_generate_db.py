"""The proposal-database path on the CPU: get_whole_scene bit-for-bit with
the JAX loader, and `python -m ws3d_tpu_torch.tools.generate_box_dataset`
against the JAX tool (tools/generate_box_dataset.py) on 2 synthetic scenes
with the same fitted stage-1 weights, record by record; the host loop's
rules on hand-made arrays; train_cascade --db on the database it writes.

At --points 512 the fitted weights (fitted on 16,384-point scenes) give no
centre vote beyond the 0.2 m gate, in either package, so the tools are
compared at 4,096 points, where each scene yields 64 proposals."""
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

from torch_port_helpers import REPO, WEIGHTS
from ws3d_tpu.config import load_config as jax_load_config
from ws3d_tpu.datasets import SyntheticKitti as JaxSynthetic
from ws3d_tpu.datasets.rpn_dataset import RPNDataset as JaxRPNDataset
from ws3d_tpu.datasets.rpn_dataset import \
    points_in_rotated_boxes_np as jax_in_boxes
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
from ws3d_tpu_torch.datasets.rpn_dataset import points_in_rotated_boxes_np
from ws3d_tpu_torch.tools.generate_box_dataset import scene_records

ENV = {"JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}


@pytest.mark.parametrize("max_points,sort_z",
                         [(16384, True), (16384, False), (512, True),
                          (None, True)])
def test_whole_scene_matches_jax(max_points, sort_z):
    """Padded (16,384 > every scene), subsampled (512) and whole clouds."""
    jcfg, cfg = jax_load_config(), load_config()
    jcfg.TPU.SORT_POINTS_Z = cfg.TPU.SORT_POINTS_Z = sort_z
    ref = JaxRPNDataset(JaxSynthetic(num_scenes=2, points_per_scene=18000,
                                     seed=1), jcfg, mode="EVAL", seed=3)
    got = RPNDataset(SyntheticKitti(num_scenes=2, points_per_scene=18000,
                                    seed=1), cfg, mode="EVAL", seed=3)
    for i in range(2):
        a, b = ref.get_whole_scene(i, max_points), got.get_whole_scene(
            i, max_points)
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if max_points == 16384:
            assert not b["valid"].all() and b["valid"].sum() == b["n_valid"]


def test_points_in_boxes_matches_jax(rng):
    pts = rng.randn(500, 3).astype(np.float32) * 3
    boxes = np.concatenate([rng.randn(6, 3) * 2, rng.uniform(1, 4, (6, 3)),
                            rng.uniform(-3, 3, (6, 1))], 1).astype(np.float32)
    got = points_in_rotated_boxes_np(pts, boxes)
    np.testing.assert_array_equal(got, jax_in_boxes(pts, boxes))
    assert got.any() and not got.all()


def _write_jax_ckpt(path):
    """The fitted npz's rpn entries as the JAX tool's --ckpt (the pickle
    load_checkpoint reads beside a path that is no orbax directory)."""
    tree = {"params": {}, "batch_stats": {}}
    with np.load(WEIGHTS) as z:
        for k in z.files:
            coll, *keys = k.split("/")
            if keys[0] != "rpn":
                continue
            node = tree[coll]
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = np.array(z[k])
    with open(str(path) + ".pkl", "wb") as f:
        pickle.dump(tree, f)


def _run(args, out_dir):
    res = subprocess.run([sys.executable, *args, "--output_dir", str(out_dir)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, **ENV))
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stderr


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("db")
    common = ["--synthetic", "--scenes", "2", "--points", "4096", "--seed",
              "0"]
    _write_jax_ckpt(tmp / "rpn")
    _run(["tools/generate_box_dataset.py", *common, "--cpu", "--ckpt",
          str(tmp / "rpn"), "--out", str(tmp / "jax.pkl")], tmp / "jax")
    log = _run(["-m", "ws3d_tpu_torch.tools.generate_box_dataset", *common,
                "--bench_weights", "--device", "cpu", "--out",
                str(tmp / "port.pkl")], tmp / "port")
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(tmp / "port.pkl", "rb") as f:
        got = pickle.load(f)
    return ref, got, log, tmp


def test_tool_matches_jax_tool(databases):
    ref, got, log, _ = databases
    assert len(ref) == len(got) > 0
    assert re.search(rf"wrote {len(got)} records", log)
    assert any(r["box_id"] >= 0 for r in got)
    assert any(not r["foreground_flag"] for r in got)
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            x, y = a[k], b[k]
            assert type(x) is type(y), k
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, k
                # one RPN forward on the same weights: f32 sums in another
                # order than XLA's
                np.testing.assert_allclose(y, x, rtol=0, atol=1e-5,
                                           err_msg=k)
            else:
                assert x == y, k


def test_cascade_trains_from_the_database(databases):
    _, got, _, tmp = databases
    log = _run(["-m", "ws3d_tpu_torch.tools.train_cascade", "--stage",
                "rcnn", "--db", str(tmp / "port.pkl"), "--steps", "2",
                "--batch", "8", "--npoints", "128", "--device", "cpu"],
               tmp / "rcnn")
    # 4 copies of each record the default --val_ratio 0.1 leaves for
    # training (the JAX tool's split)
    n_val = max(int(len(got) * 0.1), 2) if len(got) >= 8 else 0
    assert f"stage-2 dataset: {4 * (len(got) - n_val)} samples" in log
    assert (f"in-training val: {n_val} held-out crops" in log) == (n_val > 0)
    losses = [float(v) for v in re.findall(r" loss=([-\w.]+)", log)]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert (tmp / "rcnn" / "rcnn_ckpt.pt").exists()


def test_cascade_refuses_an_empty_database(tmp_path):
    with open(tmp_path / "empty.pkl", "wb") as f:
        pickle.dump([], f)
    res = subprocess.run(
        [sys.executable, "-m", "ws3d_tpu_torch.tools.train_cascade", "--db",
         str(tmp_path / "empty.pkl"), "--device", "cpu", "--output_dir",
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert "holds no records" in res.stderr


def test_scene_records_rules():
    """Invalid proposals and crops of <= 5 points are skipped, a crop past
    max_crop is cut and counted, labels follow the 0.7 / 1.5 m rules."""
    pts = np.zeros((40, 4), np.float32)
    pts[:, 0] = np.arange(40) * 0.01
    pts[:, 3] = np.arange(40) / 40
    gt = np.array([[0.1, 0.0, 0.0, 1.5, 1.6, 3.9, 0.0]], np.float32)
    sample = {"pts_input": pts, "gt_boxes": gt,
              "noise_boxes": np.array([[5.0, 0, 5.0, 1, 1, 1, 0]],
                                      np.float32),
              "sample_id": np.int32(7)}
    centers = np.array([[0.0, 0.0], [5.2, 5.0], [1.0, 1.0], [9.0, 9.0]],
                       np.float32)
    pvalid = np.array([True, True, False, True])
    idx = np.tile(np.arange(32, dtype=np.int32), (4, 1))
    count = np.array([40, 10, 30, 5], np.int32)
    scores = np.linspace(0, 1, 40).astype(np.float32)
    recs, tally = scene_records(sample, centers, scores, pvalid, idx, count,
                                max_crop=32, first_id=3)
    assert [r["instance_id"] for r in recs] == [3, 4]
    assert tally == {"recall": 1, "gt": 1, "truncated": 1, "fg": 2, "bg": 0,
                     "gfg": 1}
    first, second = recs
    assert first["cur_box_point"].shape == (32, 3) and first["box_id"] == 0
    assert first["gt_mask"].all()
    np.testing.assert_array_equal(first["cur_box_reflect"], pts[:32, 3])
    np.testing.assert_array_equal(first["cur_prob_mask"], scores[:32])
    assert second["box_id"] == -1 and second["foreground_flag"]
    assert second["cur_box_point"].shape == (10, 3)
    np.testing.assert_array_equal(second["center"],
                                  np.float32([5.2, 0.0, 5.0]))
