"""ws3d_tpu_torch.tools.bench, the port's counterpart of bench.py, on the
CPU at a small size: batch 2, NBUF 2, 1 + 2 iterations, N = 2,048 (NPOINTS
512/128/32/8), the fitted npz, against the JAX package's
make_two_stage_fn on the same batches.

- f32: the detections of the last batch, its live proposals and the most
  spilled slots equal the JAX function's; the txt files of every timed
  batch match the JAX package's writer on its output (same files, each
  detection matched, centre, dims, ry and score within 1e-3, the bound of
  tests/test_torch_two_stage.py).
- bf16 (the bench's own dtype): the line's form and the file count only.
  bf16 detection sets are compared through the diff tool's matcher, never
  slot for slot (tests/test_torch_bf16_two_stage.py does that).
- The JSON keys are bench.py's, less vs_baseline, plus device; the tool
  has no CPU mode."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import REPO, WEIGHTS, jax_detector
from ws3d_tpu_torch.tools import bench
from ws3d_tpu_torch.tools.diff_detections import load_dir, match

N, NPOINTS = 2048, (512, 128, 32, 8)
BATCH, NBUF, WARMUP, ITERS = 2, 2, 1, 2
TOL = 1e-3


def _cfg(dtype: str):
    cfg = bench.bench_config(dtype)
    cfg.RPN.NUM_POINTS = N
    cfg.RPN.SA_CONFIG.NPOINTS = list(NPOINTS)
    return cfg


def _port_run(dtype: str, out_dir: str) -> dict:
    return bench.run(_cfg(dtype), batch=BATCH, nbuf=NBUF, warmup=WARMUP,
                     iters=ITERS, device="cpu", out_dir=out_dir)


@pytest.fixture(scope="module")
def f32(tmp_path_factory):
    from ws3d_tpu.datasets.kitti_io import Calibration, save_kitti_format
    from ws3d_tpu.pipeline import make_two_stage_fn
    out = tmp_path_factory.mktemp("bench")
    got = _port_run("float32", str(out / "port"))
    jmodel, variables, jcfg = jax_detector(N, NPOINTS)
    fn = jax.jit(make_two_stage_fn(jmodel, jcfg))
    bufs = [b.numpy() for b in bench.input_batches(_cfg("float32"), BATCH,
                                                   NBUF, "cpu")]
    calib = Calibration.identity()
    spilled = []
    for it in range(ITERS):
        o = {k: np.asarray(v)
             for k, v in fn(variables, jnp.asarray(bufs[it % NBUF])).items()}
        keep = o["packed"][..., 8] > 0.5
        for j in range(BATCH):
            save_kitti_format(it * BATCH + j, calib,
                              o["packed"][j, :, 0:7][keep[j]],
                              str(out / "jax"), o["packed"][j, :, 7][keep[j]],
                              bench.IMAGE_SHAPE)
        spilled.append(int(o["spilled"]))
    ref = {"detections_last_batch": int(keep.sum()),
           "live_proposals_last_batch": int(o["n_live"]),
           "max_spilled": max(spilled)}
    return got, ref, out


def test_f32_counts_match_jax(f32):
    got, ref, _ = f32
    assert ref["live_proposals_last_batch"] > 0
    for k, v in ref.items():
        assert got[k] == v, k
    assert got["weights"] == "fitted"
    assert got["weights_overlaid"] == "272/272"
    assert got["batch"] == BATCH and got["iters"] == ITERS
    assert got["points"] == N and got["value"] > 0


def test_f32_txt_files_match_jax(f32):
    _, _, out = f32
    ref, got = load_dir(str(out / "jax")), load_dir(str(out / "port"))
    assert sorted(got) == sorted(ref) == ["%06d.txt" % i
                                          for i in range(BATCH * ITERS)]
    n = 0
    for name, a in ref.items():
        b = got[name]
        assert len(a) == len(b), name
        pairs = match(a, b)
        assert len(pairs) == len(a), name
        for i, j in pairs:
            assert np.linalg.norm(a[i, 7:10] - b[j, 7:10]) <= TOL
            assert np.abs(a[i, 4:7] - b[j, 4:7]).max() <= TOL
            r = abs(a[i, 10] - b[j, 10]) % (2 * np.pi)
            assert min(r, 2 * np.pi - r) <= TOL
            assert abs(a[i, 11] - b[j, 11]) <= TOL
        n += len(a)
    assert n > 0


def _jax_bench_keys() -> set:
    """The keys of bench.py's result dict literal."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no result dict")


def test_bf16_line_and_files(tmp_path):
    got = _port_run("bfloat16", str(tmp_path))
    assert set(got) | {"device"} == \
        _jax_bench_keys() - {"vs_baseline"} | {"device"}
    assert got["metric"] == "two_stage_scenes_per_sec"
    assert got["unit"] == "scenes/sec" and got["kitti_dump"] == "overlapped"
    assert got["weights"] == "fitted" and got["weights_overlaid"] == "272/272"
    assert np.isfinite(got["value"]) and got["value"] > 0
    assert got["max_spilled"] >= 0 and got["live_proposals_last_batch"] > 0
    assert sorted(os.listdir(tmp_path)) == ["%06d.txt" % i
                                            for i in range(BATCH * ITERS)]


def test_random_init_without_the_npz(tmp_path):
    from ws3d_tpu_torch.models import build_model
    model = build_model(_cfg("float32"), device="cpu")
    assert bench.load_weights(model, str(tmp_path / "none.npz")) == \
        ("random-init", "0/0")
    assert bench.load_weights(model, WEIGHTS) == ("fitted", "272/272")


def test_writer_reraises(tmp_path):
    writer = bench._Writer(1, str(tmp_path))
    writer.start()
    writer.jobs.put((0, torch.zeros((1, 2, 3)), None))   # not (B, K, 9)
    with pytest.raises(IndexError):
        writer.finish()
    assert not writer.is_alive()


def test_no_cpu_mode(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
