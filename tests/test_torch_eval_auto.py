"""The auto-annotator on the CPU: run_eval of both packages (the port's
ws3d_tpu_torch.tools.eval_auto and tools/eval_auto.py) on the same 4
synthetic scenes at 4,096 points, K = 8, with the fitted npz. The KITTI txt
files must hold the same detections (tools/diff_detections.match pairs
every one; centre, dims, ry and score within 1e-3), the AP dicts must agree
within 1e-4, and the CLI must run end to end."""
import copy
import logging
import os
import sys

import numpy as np
import pytest

from torch_port_helpers import REPO, jax_detector, torch_detector

sys.path.insert(0, os.path.join(REPO, "tools"))

TOL = 1e-3
SCENES = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from eval_auto import run_eval as jax_run_eval
    from ws3d_tpu.datasets import SyntheticKitti as JaxSynthetic
    from ws3d_tpu.datasets.rpn_dataset import RPNDataset as JaxRPNDataset
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.tools.eval_auto import run_eval

    out = tmp_path_factory.mktemp("eval_auto")
    log = logging.getLogger("test_torch_eval_auto")
    jmodel, variables, jcfg = jax_detector()
    tmodel, tcfg = torch_detector()
    jcfg, tcfg = copy.deepcopy(jcfg), copy.deepcopy(tcfg)
    for cfg in (jcfg, tcfg):
        cfg.TPU.MAX_PROPOSALS = 8
    jsrc = JaxSynthetic(num_scenes=SCENES, points_per_scene=20000, seed=3)
    ref = jax_run_eval(jmodel, jcfg, variables, jsrc,
                       JaxRPNDataset(jsrc, jcfg, mode="EVAL", seed=0), log,
                       scenes=SCENES, batch=SCENES,
                       output_dir=str(out / "jax"))
    tsrc = SyntheticKitti(num_scenes=SCENES, points_per_scene=20000, seed=3)
    stats = {}
    got = run_eval(tmodel, tcfg, tsrc,
                   RPNDataset(tsrc, tcfg, mode="EVAL", seed=0), log,
                   scenes=SCENES, batch=SCENES, output_dir=str(out / "port"),
                   stats=stats)
    return ref, got, stats, out


def _load_dir(d):
    """{file name: (N, 12) rows}: tools/diff_detections.load_dir's parse,
    with (0, 12) for a file without a detection (load_dir cannot reshape
    an empty one)."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            rows = [[float(v) for v in line.split()[4:]] for line in f
                    if line.split()]
        out[name] = np.array(rows, np.float64).reshape(len(rows), 12)
    return out


def test_detections_match_jax(runs):
    from diff_detections import match
    _, _, stats, out = runs
    ref = _load_dir(str(out / "jax" / "final_result" / "data"))
    got = _load_dir(str(out / "port" / "final_result" / "data"))
    assert sorted(got) == sorted(ref) == ["%06d.txt" % i
                                          for i in range(SCENES)]
    n = 0
    for name in ref:
        a, b = ref[name], got[name]
        assert len(a) == len(b), name
        pairs = match(a, b)
        assert len(pairs) == len(a), name          # none unmatched
        for i, j in pairs:
            assert np.linalg.norm(a[i, 7:10] - b[j, 7:10]) <= TOL
            assert np.abs(a[i, 4:7] - b[j, 4:7]).max() <= TOL
            r = abs(a[i, 10] - b[j, 10]) % (2 * np.pi)
            assert min(r, 2 * np.pi - r) <= TOL
            assert abs(a[i, 11] - b[j, 11]) <= TOL
        n += len(a)
    assert n > 0 and stats["detections"] == n
    assert stats["scenes"] == SCENES


def test_ap_matches_jax(runs):
    ref, got, stats, _ = runs
    assert got.keys() == ref.keys()
    for k in ref:
        assert float(got[k]) == pytest.approx(float(ref[k]), abs=1e-4), k
    assert ref["Car_3d_easy"] > 0.0
    gt, dt = stats["annos"]
    assert len(gt) == len(dt) == SCENES
    assert len(stats["recall"]) == 5
    assert set(stats["seconds"]) == {"inference", "txt", "ap"}


def test_cli_runs_on_the_cpu(tmp_path):
    """python -m ws3d_tpu_torch.tools.eval_auto with the fitted weights on
    two scenes; a --batch that --mesh does not divide is refused."""
    from ws3d_tpu_torch.tools import eval_auto
    assert eval_auto.main(["--synthetic", "--scenes", "2", "--points",
                           "4096", "--bench_weights", "--batch", "2",
                           "--cpu", "--output_dir", str(tmp_path)]) == 0
    log = (tmp_path / "log.txt").read_text()
    assert "Car 3D AP e/m/h" in log and "total bbox recall" in log
    assert sorted(os.listdir(tmp_path / "final_result" / "data")) == [
        "000000.txt", "000001.txt"]
    with pytest.raises(SystemExit, match="divisible by --mesh"):
        eval_auto.main(["--synthetic", "--batch", "3", "--mesh", "2",
                        "--cpu", "--output_dir", str(tmp_path)])
