"""The click-seeded annotator on the CPU: the port's
ws3d_tpu_torch.tools.eval_active against tools/eval_active.py. Its four
helpers must give the same arrays and errors; both tools' main on the same
2 synthetic scenes (--max_points 4096 --batch 2 --bench_weights) must keep
the same number of boxes in every result file, every box matched (the diff
tool's matcher) within 1e-3 in centre, dims and score, and the Car AP
within 3e-4."""
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_port_helpers import REPO
from ws3d_tpu_torch.tools import eval_active as port

sys.path.insert(0, os.path.join(REPO, "tools"))

TOL = 1e-3
AP_TOL = 3e-4
ARGS = ["--synthetic", "--scenes", "2", "--max_points", "4096", "--batch",
        "2", "--bench_weights", "--cpu"]


@pytest.fixture(scope="module")
def ref_tool():
    import eval_active
    return eval_active


def test_click_gaussian_mask_matches(ref_tool, rng):
    pts = (rng.randn(500, 3) * 5).astype(np.float32)
    clicks = (rng.randn(3, 3) * 5).astype(np.float32)
    args = (1.2, 0.7, 1.5)
    np.testing.assert_array_equal(port.click_gaussian_mask(pts, clicks, *args),
                                  ref_tool.click_gaussian_mask(pts, clicks,
                                                               *args))


@pytest.mark.parametrize("m", [1, 5, 6, 20, 40])
def test_expand_clicks_matches(ref_tool, rng, m):
    c = (rng.randn(m, 2) * 10).astype(np.float32)
    for a, b in zip(port.expand_clicks(c), ref_tool.expand_clicks(c)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_expand_clicks_refuses_like_jax(ref_tool):
    c = np.zeros((41, 2), np.float32)
    with pytest.raises(ValueError) as a:
        port.expand_clicks(c)
    with pytest.raises(ValueError) as b:
        ref_tool.expand_clicks(c)
    assert str(a.value) == str(b.value)


def test_plan_batches_and_v_buckets_match(ref_tool):
    keys = [(4096, 128), (8192, 128), (4096, 128), (4096, 256),
            (4096, 128), (8192, 128), (4096, 128)]
    for bs in (1, 2, 3, 8):
        assert port.plan_batches(keys, bs) == ref_tool.plan_batches(keys, bs)
    assert port.SLOT_BUCKETS == ref_tool.SLOT_BUCKETS
    assert port.V_BUCKETS == ref_tool.V_BUCKETS
    for n_live in (0, 1, 127, 128, 129, 700, 2048, 5000, 9000):
        for max_v in (256, 1024, 8192, 16384):
            assert port.pick_v_bucket(n_live, max_v) == \
                ref_tool.pick_v_bucket(n_live, max_v)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both tools' output directories: the JAX tool in a process of its own
    while the port's main runs in this one."""
    out = tmp_path_factory.mktemp("eval_active")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tools", "eval_active.py"),
         "--output_dir", str(out / "jax")] + ARGS, cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        assert port.main(ARGS + ["--output_dir", str(out / "port")]) == 0
    finally:
        log, _ = ref.communicate(timeout=300)
    assert ref.returncode == 0, log[-3000:]
    return out


def _load_dir(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            rows = [[float(v) for v in line.split()[4:]] for line in f
                    if line.split()]
        out[name] = np.array(rows, np.float64).reshape(len(rows), 12)
    return out


def test_detections_match_jax(runs):
    from diff_detections import match
    ref = _load_dir(str(runs / "jax" / "final_result" / "data"))
    got = _load_dir(str(runs / "port" / "final_result" / "data"))
    assert sorted(got) == sorted(ref) == ["000000.txt", "000001.txt"]
    total = 0
    for name in ref:
        a, b = ref[name], got[name]
        assert len(a) == len(b), name
        pairs = match(a, b)
        assert len(pairs) == len(a), name
        for i, j in pairs:
            assert np.linalg.norm(a[i, 7:10] - b[j, 7:10]) <= TOL
            assert np.abs(a[i, 4:7] - b[j, 4:7]).max() <= TOL
            assert abs(a[i, 11] - b[j, 11]) <= TOL
        total += len(a)
    assert total > 0


def test_car_ap_matches_jax(runs):
    from ws3d_tpu.datasets import SyntheticKitti as JaxSynthetic
    from ws3d_tpu.eval import annos_from_objects as jax_annos
    from ws3d_tpu.eval import get_official_eval_result as jax_ap
    from ws3d_tpu.eval.kitti_ap import anno_from_lines as jax_lines
    from ws3d_tpu_torch.datasets import SyntheticKitti
    from ws3d_tpu_torch.eval import annos_from_objects, get_official_eval_result
    from ws3d_tpu_torch.eval.kitti_ap import anno_from_lines

    def dt(side, parse):
        d = runs / side / "final_result" / "data"
        return [parse(open(d / f"{i:06d}.txt").readlines()) for i in (0, 1)]
    jsrc = JaxSynthetic(num_scenes=2, points_per_scene=18000, seed=0)
    tsrc = SyntheticKitti(num_scenes=2, points_per_scene=18000, seed=0)
    _, ref = jax_ap(jax_annos([jsrc.get_scene(i).labels for i in (0, 1)]),
                    dt("jax", jax_lines), ["Car"])
    _, got = get_official_eval_result(
        annos_from_objects([tsrc.get_scene(i).labels for i in (0, 1)]),
        dt("port", anno_from_lines), ["Car"])
    keys = [k for k in ref if k.startswith("Car_")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        assert abs(float(got[k]) - float(ref[k])) <= AP_TOL, k
    assert max(float(ref[k]) for k in keys) > 0.0
