"""The port's KITTI AP harness against the JAX package's, on the CPU, on
seeded random annos (cars matched with small errors, vans, pedestrians,
DontCare regions, false positives, every difficulty): the rotated overlap
(1e-9), the per-frame statistics, the official result through the port's
NumPy path and its native binding (the AP dict within 1e-6, the same
table), and the recall tally."""
import numpy as np
import pytest

from ws3d_tpu.eval import kitti_ap as jap
from ws3d_tpu.eval import recall as jrecall
from ws3d_tpu.eval.rotate_iou_np import rotate_iou_eval as jax_np_iou
from ws3d_tpu_torch import native
from ws3d_tpu_torch.eval import kitti_ap as tap
from ws3d_tpu_torch.eval import recall as trecall
from ws3d_tpu_torch.eval.rotate_iou_np import rotate_iou_eval as np_iou


def _bev_boxes(rng, n):
    """(n, 5) [x, z, l, w, ry], overlapping in clusters."""
    c = rng.uniform(-6, 6, (3, 2))[rng.randint(0, 3, n)]
    return np.concatenate([c + rng.randn(n, 2) * 1.5,
                           rng.uniform(1.0, 4.5, (n, 2)),
                           rng.uniform(-np.pi, np.pi, (n, 1))], 1)


def _frame(rng, aos):
    """One frame's (gt, dt) annos."""
    n_gt = rng.randint(0, 7)
    names = rng.choice(["Car", "Car", "Car", "Van", "Pedestrian",
                        "DontCare"], n_gt)
    h2d = rng.uniform(15, 120, n_gt)
    x1, y1 = rng.uniform(0, 1100, n_gt), rng.uniform(120, 250, n_gt)
    gt = {"name": names, "truncated": rng.uniform(0, 0.6, n_gt),
          "occluded": rng.randint(0, 4, n_gt),
          "alpha": rng.uniform(-np.pi, np.pi, n_gt),
          "bbox": np.stack([x1, y1, x1 + 1.5 * h2d, y1 + h2d], 1).reshape(
              -1, 4),
          "dimensions": np.stack([rng.uniform(3.2, 4.8, n_gt),
                                  rng.uniform(1.4, 1.8, n_gt),
                                  rng.uniform(1.5, 1.9, n_gt)], 1).reshape(
              -1, 3),
          "location": np.stack([rng.uniform(-15, 15, n_gt),
                                rng.uniform(1.5, 1.8, n_gt),
                                rng.uniform(5, 60, n_gt)], 1).reshape(-1, 3),
          "rotation_y": rng.uniform(-np.pi, np.pi, n_gt),
          "score": np.zeros(n_gt)}
    # detections: most gt objects seen with small errors, plus false ones
    seen = np.nonzero(rng.rand(n_gt) < 0.8)[0]
    n_fp = rng.randint(0, 3)
    k = len(seen) + n_fp
    pick = np.concatenate([seen, rng.randint(0, max(n_gt, 1), n_fp)]
                          ).astype(int) if n_gt else np.zeros(0, int)
    k = len(pick)
    err = np.concatenate([np.full(len(seen), 0.15), np.full(k - len(seen),
                                                            3.0)])
    dt = {"name": np.where(rng.rand(k) < 0.9, "Car", "Pedestrian"),
          "truncated": np.full(k, -1.0), "occluded": np.full(k, -1),
          "alpha": (gt["alpha"][pick] + rng.randn(k) * 0.2 if aos
                    else np.full(k, -10.0)),
          "bbox": (gt["bbox"][pick] + rng.randn(k, 4) * err[:, None] * 10
                   ).reshape(-1, 4),
          "dimensions": (gt["dimensions"][pick] + rng.randn(k, 3) * 0.1
                         ).reshape(-1, 3),
          "location": (gt["location"][pick] + rng.randn(k, 3) * err[:, None]
                       ).reshape(-1, 3),
          "rotation_y": gt["rotation_y"][pick] + rng.randn(k) * 0.1,
          "score": rng.uniform(0.05, 1.0, k)}
    return gt, dt


def _annos(rng, n, aos):
    frames = [_frame(rng, aos) for _ in range(n)]
    return [f[0] for f in frames], [f[1] for f in frames]


def test_native_library_loads():
    assert native.available()
    assert tap.use_native(None) and tap.use_native(True)
    assert not tap.use_native(False)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotate_iou_matches_jax(rng, criterion):
    a, b = _bev_boxes(rng, 40), _bev_boxes(rng, 30)
    ref = jax_np_iou(a, b, criterion)
    np.testing.assert_array_equal(np_iou(a, b, criterion), ref)
    np.testing.assert_array_equal(tap.rotate_iou_eval(a, b, criterion,
                                                      native=False), ref)
    got = tap.rotate_iou_eval(a, b, criterion, native=True)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got, jap.rotate_iou_eval(a, b, criterion))
    assert (ref > 0.05).mean() > 0.1          # the clusters overlap


@pytest.mark.parametrize("metric", [0, 1, 2])
def test_compute_statistics_matches_jax(rng, metric):
    """The per-frame statistics, thresholded with false positives counted
    (with orientation similarity) and not, through both paths."""
    gts, dts = _annos(rng, 6, aos=True)
    ov = tap._frame_overlaps(gts, dts, metric, native=False)
    ov_n = tap._frame_overlaps(gts, dts, metric, native=True)
    for i in range(6):
        np.testing.assert_allclose(ov_n[i], ov[i], rtol=0, atol=1e-9)
        data = tap._prepare_data(gts[i:i + 1], dts[i:i + 1], 0, 1)
        jdata = jap._prepare_data(gts[i:i + 1], dts[i:i + 1], 0, 1)
        for x, y in zip(data[:5], jdata[:5]):
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v)
        args = [ov[i]] + [d[0] for d in data[:5]] + [metric, 0.5]
        for kw in ({}, {"thresh": 0.4, "compute_fp": True,
                        "compute_aos": True}):
            ref = jap.compute_statistics(*args, **kw)
            for got in (tap.compute_statistics(*args, **kw),
                        native.compute_statistics(*args, **kw)):
                assert got[:3] == ref[:3]
                assert got[3] == pytest.approx(ref[3], abs=1e-9)
                np.testing.assert_array_equal(got[4], ref[4])


@pytest.mark.parametrize("classes,aos", [("Car", False), ("Car", True),
                                         (["Car", "Pedestrian"], True)])
def test_official_result_matches_jax(rng, monkeypatch, classes, aos):
    """The JAX harness through its native library and, patched off it,
    through its NumPy path, against the port's two paths: the same AP dict
    (1e-6) and the same table."""
    gts, dts = _annos(rng, 8, aos)
    ref_text, ref = jap.get_official_eval_result(gts, dts, classes)
    monkeypatch.setattr(jap, "_HAVE_NATIVE", False)
    ref_np_text, ref_np = jap.get_official_eval_result(gts, dts, classes)
    for nat, (rt, rd) in ((True, (ref_text, ref)),
                          (False, (ref_np_text, ref_np))):
        text, got = tap.get_official_eval_result(gts, dts, classes,
                                                 native=nat)
        assert text == rt
        assert got.keys() == rd.keys() == ref.keys()
        for k in got:
            assert got[k] == pytest.approx(rd[k], abs=1e-6), k
            assert got[k] == pytest.approx(ref[k], abs=1e-6), k
    assert ("aos  AP" in ref_text) == aos
    assert 0.0 < ref["Car_3d_moderate"] < 100.0


def test_eval_class_arrays_match_jax(rng):
    gts, dts = _annos(rng, 6, aos=False)
    ov = np.array([[[0.7, 0.5, 0.5, 0.7, 0.5]] * 3])[:, :, [0]]
    for metric in (0, 1, 2):
        ref = jap.eval_class(gts, dts, [0], [0, 1, 2], metric, ov)
        for nat in (True, False):
            got = tap.eval_class(gts, dts, [0], [0, 1, 2], metric, ov,
                                 native=nat)
            for k in ("recall", "precision"):
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-9)


def test_annos_from_objects_and_lines_match_jax(tmp_path):
    from ws3d_tpu.datasets.kitti_io import Object3d as JaxObject3d
    from ws3d_tpu_torch.datasets.kitti_io import Object3d
    lines = ["Car 0.00 0 -1.58 587.01 173.33 614.12 230.12 1.65 1.67 3.64 "
             "-0.65 1.71 46.70 -1.59 0.9100",
             "Van 0.20 1 1.20 100.00 150.00 300.00 190.00 2.10 1.90 5.00 "
             "3.00 1.70 20.00 0.50 0.2500"]
    got = tap.annos_from_objects([[Object3d.from_line(s) for s in lines], []])
    ref = jap.annos_from_objects([[JaxObject3d.from_line(s) for s in lines],
                                  []])
    for a, b in zip(got + [tap.anno_from_lines(lines)],
                    ref + [jap.anno_from_lines(lines)]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    path = tmp_path / "000002.txt"
    path.write_text("\n".join(lines) + "\n")
    for a, b in zip(tap.get_label_annos(str(tmp_path), [2]),
                    jap.get_label_annos(str(tmp_path), [2])):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_recall_tally_matches_jax(rng):
    got, ref = trecall.RecallTally(), jrecall.RecallTally()
    for _ in range(5):
        g = rng.randint(0, 6)
        gt = np.concatenate([rng.uniform(-10, 10, (g, 1)),
                             rng.uniform(1.5, 1.8, (g, 1)),
                             rng.uniform(5, 40, (g, 1)),
                             rng.uniform(1.4, 1.8, (g, 1)),
                             rng.uniform(1.5, 1.9, (g, 1)),
                             rng.uniform(3.2, 4.8, (g, 1)),
                             rng.uniform(-3, 3, (g, 1))], 1).astype(
                                 np.float32)
        pred = gt[rng.rand(g) < 0.7] + rng.randn(1, 7).astype(
            np.float32) * np.array([0.3, 0.05, 0.3, 0.1, 0.1, 0.2, 0.1],
                                   np.float32)
        for tally in (got, ref):
            tally.update(pred, gt)
    assert got.recalled == ref.recalled and got.total_gt == ref.total_gt
    assert got.summary_lines() == ref.summary_lines()
    assert 0 < got.recalled[0] < got.total_gt + 1
