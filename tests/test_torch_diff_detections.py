"""The port's detection diff (ws3d_tpu_torch/tools/diff_detections.py)
against the JAX package's tool (tools/diff_detections.py) on the same two
result directories: the same JSON record, key for key. Detections are
written in the KITTI result format with numpy-seeded boxes: some moved a
little (matched), some far (unmatched on both sides), several close to one
another (where a row-by-row greedy match would differ from the global
argmin). A txt file with no detection counts as zero rows in the port's
tool; the JAX tool raises on one."""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from torch_port_helpers import REPO
from ws3d_tpu_torch.tools import diff_detections


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_diff_detections", os.path.join(REPO, "tools",
                                            "diff_detections.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(d, name, rows):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, name), "w") as f:
        for r in rows:
            f.write("Car -1 -1 %.4f " % -10 + " ".join(
                "%.4f" % v for v in r) + "\n")


def _scenes(rng, tmp_path):
    a_dir, b_dir = str(tmp_path / "a"), str(tmp_path / "b")
    for s in range(4):
        k = 3 + s
        rows = np.concatenate([
            rng.rand(k, 4) * 100,                          # bbox
            1.5 + rng.rand(k, 3),                          # h w l
            rng.randn(k, 3) * 10,                          # x y z
            rng.uniform(-np.pi, np.pi, (k, 1)),            # ry
            rng.rand(k, 1)], axis=1)                       # score
        rows[1, 7:10] = rows[0, 7:10] + 0.3                # a close pair
        other = rows + np.concatenate([
            np.zeros((k, 4)), rng.randn(k, 3) * 0.02, rng.randn(k, 3) * 0.1,
            rng.randn(k, 1) * 0.05, rng.randn(k, 1) * 0.01], axis=1)
        other[-1, 7:10] += 30.0                            # unmatched
        _write(a_dir, "%06d.txt" % s, rows)
        _write(b_dir, "%06d.txt" % s, other[: k - (s % 2)])
    _write(a_dir, "%06d.txt" % 9, rows[:2])               # only in a
    return a_dir, b_dir


@pytest.mark.parametrize("tol", [2.0, 0.25])
def test_port_tool_matches_the_jax_tool(rng, tmp_path, capsys, monkeypatch,
                                        tol):
    a_dir, b_dir = _scenes(rng, tmp_path)
    argv = [a_dir, b_dir, "--tol", str(tol)]
    monkeypatch.setattr(sys, "argv", ["diff_detections.py"] + argv)
    _jax_tool().main()
    ref = json.loads(capsys.readouterr().out)
    assert diff_detections.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == ref
    assert ref["only_a"] > 0 and ref["only_b"] > 0 and ref["matched"] > 0
    assert got == diff_detections.diff(a_dir, b_dir, tol)


def test_empty_txt_counts_as_zero_rows(rng, tmp_path, monkeypatch):
    a_dir, b_dir = _scenes(rng, tmp_path)
    without = diff_detections.diff(a_dir, b_dir)
    _write(b_dir, "%06d.txt" % 9, [])                     # no detection
    _write(a_dir, "%06d.txt" % 10, [])
    assert diff_detections.load_dir(b_dir)["000009.txt"].shape == (0, 12)
    # an empty file is a scene with no detection: the record is unchanged
    assert diff_detections.diff(a_dir, b_dir) == without
    monkeypatch.setattr(sys, "argv", ["diff_detections.py", a_dir, b_dir])
    with pytest.raises(ValueError):          # the JAX tool's loader
        _jax_tool().main()
