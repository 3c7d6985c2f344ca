"""The port's KITTI files against the JAX package's, on the CPU:
save_kitti_format writes the same bytes (boxes, no box, and boxes covering
more than 80 % of the image, under the synthetic and the devkit
calibration); write_kitti_tree writes the same tree and both KittiRaw
readers read equal scenes from it (points, calibration, label lines,
difficulty levels); clicks_to_noise_labels writes the same files; and
`train_rpn --data_root` trains a step on a written tree."""
import os

import numpy as np
import pytest

from ws3d_tpu.datasets import kitti_io as jio
from ws3d_tpu_torch.datasets import SyntheticKitti
from ws3d_tpu_torch.datasets import kitti_io as tio


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for name in names:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _boxes(rng, case):
    """(N, 7) bottom-y camera boxes [x, y, z, h, w, l, ry] and scores."""
    if case == "empty":
        return np.zeros((0, 7), np.float32), np.zeros(0, np.float32)
    k = 12
    boxes = np.concatenate([
        rng.uniform(-15, 15, (k, 1)), rng.uniform(1.2, 2.0, (k, 1)),
        rng.uniform(4, 60, (k, 1)), rng.uniform(1.3, 2.0, (k, 1)),
        rng.uniform(1.4, 2.0, (k, 1)), rng.uniform(3.2, 4.8, (k, 1)),
        rng.uniform(-np.pi, np.pi, (k, 1))], 1).astype(np.float32)
    if case == "covering":
        # boxes just in front of the camera fill the image: dropped
        boxes[:4, 0] = rng.uniform(-0.5, 0.5, 4)
        boxes[:4, 2] = rng.uniform(1.0, 2.0, 4)
        boxes[:4, 3:6] = 3.0
    return boxes, rng.uniform(0.0, 1.0, k).astype(np.float32)


@pytest.mark.parametrize("calib", ["identity", "realistic"])
@pytest.mark.parametrize("case", ["boxes", "empty", "covering"])
def test_save_kitti_format_bytes_match_jax(rng, tmp_path, case, calib):
    boxes, scores = _boxes(rng, case)
    shape = (375, 1242)
    for pkg in (tio, jio):
        getattr(pkg, "save_kitti_format")(
            7, getattr(pkg.Calibration, calib)(), boxes,
            str(tmp_path / pkg.__name__), scores, shape)
    got = _files(tmp_path / tio.__name__)
    ref = _files(tmp_path / jio.__name__)
    assert got == ref and list(got) == ["000007.txt"]
    lines = got["000007.txt"].decode().splitlines()
    if case == "empty":
        assert lines == []
    elif case == "covering":
        assert 0 < len(lines) < len(boxes)      # the covering boxes dropped
    else:
        assert len(lines) > 0


def _scenes(n=3, points=1500, seed=9):
    src = SyntheticKitti(num_scenes=n, points_per_scene=points, seed=seed,
                         realistic=True)
    return [src.get_scene(i, with_noise=True) for i in range(n)]


def _same_objects(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.to_kitti_line() == y.to_kitti_line()
        assert (x.cls_type, x.level, x.cls_id, x.score) == \
            (y.cls_type, y.level, y.cls_id, y.score)
        np.testing.assert_array_equal(x.box2d, y.box2d)
        np.testing.assert_array_equal(x.pos, y.pos)


def test_kitti_tree_round_trip_matches_jax(tmp_path):
    scenes = _scenes()
    tio.write_kitti_tree(str(tmp_path / "port"), scenes,
                         extra_splits=[("val", [1, 2])])
    jio.write_kitti_tree(str(tmp_path / "jax"), scenes,
                         extra_splits=[("val", [1, 2])])
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")

    got = tio.KittiRaw(str(tmp_path / "port"), split="train")
    ref = jio.KittiRaw(str(tmp_path / "port"), split="train")
    assert got.sample_ids == ref.sample_ids == [0, 1, 2]
    assert tio.KittiRaw(str(tmp_path / "port"), split="val").sample_ids \
        == [1, 2]
    for sid in got.sample_ids:
        a, b = got.get_scene(sid, with_noise=True), ref.get_scene(
            sid, with_noise=True)
        np.testing.assert_array_equal(a.pts_lidar, b.pts_lidar)
        np.testing.assert_array_equal(a.pts_lidar, scenes[sid].pts_lidar)
        np.testing.assert_array_equal(a.pts_rect, b.pts_rect)
        assert a.image_shape == b.image_shape
        for m in ("P2", "R0", "V2C"):
            np.testing.assert_array_equal(getattr(a.calib, m),
                                          getattr(b.calib, m))
        _same_objects(a.labels, b.labels)
        _same_objects(a.noise_labels, b.noise_labels)
        assert len(a.labels) == len(scenes[sid].labels)
        # the projections of the calibration read back
        pts = a.pts_lidar[:50, :3]
        for x, y in zip(a.calib.lidar_to_img(pts), b.calib.lidar_to_img(pts)):
            np.testing.assert_array_equal(x, y)
        img, depth = a.calib.lidar_to_img(pts)
        np.testing.assert_array_equal(
            a.calib.img_to_rect(img[:, 0], img[:, 1], depth),
            b.calib.img_to_rect(img[:, 0], img[:, 1], depth))


def test_objects_from_label_match_jax(tmp_path):
    """Label lines with and without a score, every difficulty level."""
    path = tmp_path / "000001.txt"
    path.write_text(
        "Car 0.00 0 -1.58 587.01 173.33 614.12 230.12 1.65 1.67 3.64 "
        "-0.65 1.71 46.70 -1.59\n"
        "Van 0.20 1 1.20 100.00 150.00 300.00 190.00 2.10 1.90 5.00 "
        "3.00 1.70 20.00 0.50\n"
        "Pedestrian 0.40 2 0.10 700.00 160.00 720.00 190.00 1.70 0.60 "
        "0.80 1.00 1.60 30.00 0.10\n"
        "Car 0.90 3 0.00 10.00 10.00 20.00 20.00 1.50 1.60 3.90 "
        "5.00 1.60 60.00 1.00 0.8765\n"
        "DontCare -1 -1 -10 800.00 170.00 840.00 190.00 -1 -1 -1 "
        "-1000 -1000 -1000 -10\n")
    got = tio.get_objects_from_label(str(path))
    ref = jio.get_objects_from_label(str(path))
    _same_objects(got, ref)
    assert [o.level for o in got] == [1, 2, 3, 4, 4]
    np.testing.assert_array_equal(tio.objs_to_boxes3d(got),
                                  jio.objs_to_boxes3d(ref))
    np.testing.assert_array_equal(
        tio.boxes3d_to_corners3d_np(tio.objs_to_boxes3d(got)),
        jio.boxes3d_to_corners3d_np(jio.objs_to_boxes3d(ref)))


def test_clicks_to_noise_labels_match_jax(tmp_path):
    clicks = tmp_path / "label.txt"
    clicks.write_text("000003 1.5 20.25 1.4 20.0\n"
                      "000003 -4.0 33.0 -3.9 33.2\n"
                      "short line\n"
                      "000007 0.5 10.0 0.4 10.1\n")
    got = tio.clicks_to_noise_labels(str(clicks), str(tmp_path / "port"),
                                     sample_ids=[3, 7, 9])
    ref = jio.clicks_to_noise_labels(str(clicks), str(tmp_path / "jax"),
                                     sample_ids=[3, 7, 9])
    assert got == ref == {3: 2, 7: 1, 9: 0}
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_train_rpn_reads_a_kitti_tree(tmp_path):
    from ws3d_tpu_torch.tools import train_rpn
    scenes = _scenes(n=4, points=3000, seed=11)
    root = str(tmp_path / "kitti")
    tio.write_kitti_tree(root, scenes)
    out = tmp_path / "out"
    assert train_rpn.main(["--data_root", root, "--steps", "1", "--batch",
                           "2", "--points", "512", "--device", "cpu",
                           "--ckpt_every", "1", "--output_dir",
                           str(out)]) == 0
    assert (out / "rpn_ckpt.pt").exists()
    assert (out / "rpn_weights.npz").exists()
    log = (out / "log.txt").read_text()
    assert "dataset: 4 scenes" in log and "step" in log
