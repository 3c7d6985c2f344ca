"""The whole slice in bf16: make_two_stage_fn of both packages with
cfg.TPU.COMPUTE_DTYPE=bfloat16 on 8 synthetic scenes from the JAX loader
(N = 4096, K = 16, full widths, the fitted npz through weights.py; the JAX
package on its CPU path, whose dense layers are bf16 and whose SA stages
and FP folds are XLA).

- Index results depend on xyz alone and are equal exactly: every FPS call
  of the port's bf16 run (backbone and stage-2 stacks) against the JAX
  package's FPS on the same cloud, and the port's stage-2 crops against
  the JAX package's crop step on the same points, scores and centres.
- bf16 moves scores, so near-ties may keep other proposals or detections:
  the detection sets are compared through the diff tool's greedy matcher
  (ws3d_tpu_torch.tools.diff_detections.match, 2 m), as BENCH.md:556-568
  bounds bf16 against f32 for the JAX package. Bounds, port bf16 against
  JAX bf16 and against port f32 alike: at most 1 unmatched detection over
  the 8 scenes (measured 0 of 7), matched centres within 0.15 m (max) and
  0.05 m (mean; measured 0.062 / 0.018), scores within 0.05 (max) and 0.02
  (mean; measured 0.019 / 0.007), and equal `spilled` and `n_live`."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ws3d_tpu_torch.models.pointnet2 as tp2
import ws3d_tpu_torch.pipeline.inference as tinf
from torch_port_helpers import (WEIGHTS, jax_detector, n, small_cfg,
                                synthetic_batch, t)
from ws3d_tpu.models import build_model as jax_build
from ws3d_tpu.ops.sampling import furthest_point_sample
from ws3d_tpu.pipeline import make_two_stage_fn as jax_two_stage
from ws3d_tpu.pipeline.inference import crop_for_rcnn_batched
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.pipeline import make_two_stage_fn
from ws3d_tpu_torch.tools.diff_detections import match
from ws3d_tpu_torch.weights import load_npz

SCENES, K = 8, 16
BOUNDS = {"unmatched": 1, "center_max": 0.15, "center_mean": 0.05,
          "score_max": 0.05, "score_mean": 0.02}


def _port_run(pts, dtype, record=None):
    cfg = small_cfg(load_config)
    cfg.TPU.COMPUTE_DTYPE = dtype
    model = build_model(cfg, device="cpu")
    load_npz(model, WEIGHTS)
    fn = make_two_stage_fn(model, cfg, max_proposals=K)
    if record is None:
        return {k: n(v) for k, v in fn(t(pts)).items()}
    fps, crop = tp2.furthest_point_sample_with_coords, \
        tinf.crop_for_rcnn_batched

    def fps_rec(xyz, npoint):
        out = fps(xyz, npoint)
        record["fps"].append((n(xyz), npoint, n(out[0])))
        return out

    def crop_rec(*args, **kw):
        out = crop(*args, **kw)
        record["crop"].append(([n(a) for a in args[:3]], kw,
                               {k: n(v) for k, v in out[0].items()},
                               n(out[1])))
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp2, "furthest_point_sample_with_coords", fps_rec)
        mp.setattr(tinf, "crop_for_rcnn_batched", crop_rec)
        return {k: n(v) for k, v in fn(t(pts)).items()}


@pytest.fixture(scope="module")
def runs():
    pts = synthetic_batch(SCENES, 4096, seed=3)
    _, variables, cfg = jax_detector()
    cfg = copy.deepcopy(cfg)
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    ref = jax.jit(jax_two_stage(jax_build(cfg), cfg, max_proposals=K))(
        variables, jnp.asarray(pts))
    record = {"fps": [], "crop": []}
    got = _port_run(pts, "bfloat16", record)
    return dict(ref={k: np.asarray(v) for k, v in ref.items()}, got=got,
                f32=_port_run(pts, "float32"), record=record)


def test_fps_picks_equal(runs):
    calls = runs["record"]["fps"]
    # four backbone stages, three of the trunk's and three of the cascade's
    assert len(calls) == 10
    for xyz, npoint, idx in calls:
        ref = np.asarray(furthest_point_sample(jnp.asarray(xyz), npoint))
        np.testing.assert_array_equal(idx, ref)


def test_crop_slots_equal(runs):
    (pts, scores, centers), kw, crops, empty = runs["record"]["crop"][0]
    ref, ref_empty = crop_for_rcnn_batched(
        jnp.asarray(pts), jnp.asarray(scores), jnp.asarray(centers), **kw)
    np.testing.assert_array_equal(empty, np.asarray(ref_empty))
    assert not empty.all()
    for k, v in crops.items():
        np.testing.assert_array_equal(v, np.asarray(ref[k]), err_msg=k)


def _rows(out, s):
    """The kept detections of scene s as result-file rows (the diff tool's
    columns: bbox, h w l, x y z, ry, score)."""
    keep = out["keep"][s]
    b, sc = out["boxes"][s][keep], out["scores"][s][keep]
    return np.concatenate([np.zeros((len(b), 4)), b[:, 3:6], b[:, 0:3],
                           b[:, 6:7], sc[:, None]], axis=1)


@pytest.mark.parametrize("other", ["ref", "f32"])
def test_detection_sets_match(runs, other):
    got, ref = runs["got"], runs[other]
    assert int(got["spilled"]) == int(ref["spilled"])
    assert int(got["n_live"]) == int(ref["n_live"]) > 0
    assert got["packed"].dtype == np.float32
    n_a = n_b = 0
    dc, ds = [], []
    for s in range(SCENES):
        a, b = _rows(got, s), _rows(ref, s)
        n_a, n_b = n_a + len(a), n_b + len(b)
        for i, j in match(a, b):
            dc.append(float(np.linalg.norm(a[i, 7:10] - b[j, 7:10])))
            ds.append(abs(float(a[i, 11] - b[j, 11])))
    print(f"port bf16 vs {other}: {n_a} / {n_b} detections, {len(dc)} "
          f"matched; centre max {max(dc):.4f} mean {np.mean(dc):.4f} m; "
          f"score max {max(ds):.4f} mean {np.mean(ds):.4f}")
    assert len(dc) >= 5
    assert n_a + n_b - 2 * len(dc) <= BOUNDS["unmatched"]
    assert max(dc) <= BOUNDS["center_max"]
    assert np.mean(dc) <= BOUNDS["center_mean"]
    assert max(ds) <= BOUNDS["score_max"]
    assert np.mean(ds) <= BOUNDS["score_mean"]
    # bf16 really moved the detections against the f32 port
    if other == "f32":
        assert max(dc) > 0 and max(ds) > 0
