"""Whole paths of the port on the card at main-path widths: every kernel call
a path makes replayed against its plain version, the card against the CPU
on a scene, a step or a crop batch, the kernels' launch counts a step or a
batch, and the instructions the kernels compile to. The gates are those of
tests/torch_card_helpers.py.

Marked `cuda`: without a CUDA device these skip. On the card, with the
other card files:

    python -m pytest tests/test_torch_cuda.py tests/test_torch_bn_relu.py \\
        tests/test_torch_card_paths.py -q -m cuda --noconftest

(--noconftest: tests/conftest.py imports JAX, which the card's machine
need not have; this file imports neither JAX nor ws3d_tpu.)
"""
import contextlib
import gc
import io
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_card_helpers import (BF16_BN_TOL, BF16_GATE, BF16_GRAD_MEDIAN,
                                GLOBAL_GRAD_FACTOR, GLOBAL_GRAD_MEDIAN,
                                GLOBAL_GRAD_WORST, GLOBAL_GRAD_WORST_FLOOR,
                                REPO, WEIGHTS, Recorder, bf16_gate,
                                check_call, check_calls, check_detections,
                                check_records, check_txt, deterministic, gap,
                                grad_gaps, split_bn_sums, within)
from ws3d_tpu_torch.config import load_config
from ws3d_tpu_torch.datasets import (BoxPlaceDataset, RPNDataset,
                                     SyntheticKitti,
                                     synthetic_proposal_database)
from ws3d_tpu_torch.models import build_model
from ws3d_tpu_torch.ops import (_kernels, ball_query, crop_gather, fused_sa,
                                fused_sa_idx, interpolate)
from ws3d_tpu_torch.parallel import launch
from ws3d_tpu_torch.parallel.dryrun import (cpu_state, max_diff, one_step,
                                            stage2_model)
from ws3d_tpu_torch.pipeline import make_two_stage_fn
from ws3d_tpu_torch.tools import bench
from ws3d_tpu_torch.tools.diff_detections import load_txt
from ws3d_tpu_torch.tools.eval_auto import run_eval
from ws3d_tpu_torch.tools.train_cascade import configure, split_database
from ws3d_tpu_torch.training import Trainer
from ws3d_tpu_torch.training.trainer import (RPN_INPUTS, batch_to_device,
                                             rcnn_gradients, rpn_gradients,
                                             step_inputs,
                                             trainable_parameters)
from ws3d_tpu_torch.utils.profiling import TRACE
from ws3d_tpu_torch.weights import load_flat, to_flat

pytestmark = pytest.mark.cuda

INFERENCE_KERNELS = ("fps", "fused_sa_window", "fused_sa_full",
                     "three_interpolate", "crop_gather", "greedy_sweep")
BF16_INFERENCE_KERNELS = ("fps", "fused_sa_window_bf16", "fused_sa_full_bf16",
                          "three_interpolate_bf16", "crop_gather",
                          "greedy_sweep", "fused_sa_window_bf16r",
                          "fused_sa_full_bf16r")
# the f32 and eval modes no bf16 path may launch
F32_MODES = ("fused_sa_window", "fused_sa_full", "fused_sa_idx",
             "three_interpolate")
TRAIN_KERNELS = ("fps", "three_interpolate", "ball_query", "three_nn")
# the train-mode BatchNorm + ReLU: forward, the backward's sums and dx,
# each once a layer (24 SA, 8 FP and 2 head layers) of a stage-1 step
BN_KERNELS = ("bn_relu", "bn_relu_sums", "bn_relu_dx")
BN_LAYERS = 34
BATCH = 16                  # the inference and stage-1 batch; eval's scenes
STAGE2_BATCH = 800          # crops of a stage-2 step (tools/bench_train.py)
STAGE2_POINTS = 512
# kernel launches of one stage-2 step: the SA stack's forward (FPS per
# sampled stage; SA0/SA1 windowed, SA2 full) and one ball query per fused
# stage in the backward; an IOUN step also runs the frozen trunk's forward
STAGE2_STEP_LAUNCHES = {
    "rcnn": {"fps": 3, "fused_sa_window": 2, "fused_sa_full": 1,
             "ball_query": 3},
    "ioun": {"fps": 6, "fused_sa_window": 4, "fused_sa_full": 2,
             "ball_query": 3}}
TRAIN_CASES = [(s, d) for s in ("rpn", "rcnn", "ioun")
               for d in ("float32", "bfloat16")]


@pytest.fixture(scope="module")
def card():
    """The card, f32 as the plain versions compute (no TF32 in the dense
    layers or cuDNN, bf16 GEMMs summed in f32), and every host core for
    the CPU sides of the comparisons."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = ((torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cudnn, "allow_tf32"),
             (torch.backends.cuda.matmul,
              "allow_bf16_reduced_precision_reduction"))
    saved = [getattr(o, a) for o, a in flags], torch.get_num_threads()
    for o, a in flags:
        setattr(o, a, False)
    torch.set_num_threads(os.cpu_count() or 1)
    yield torch.device("cuda")
    for (o, a), v in zip(flags, saved[0]):
        setattr(o, a, v)
    torch.set_num_threads(saved[1])


@pytest.fixture(autouse=True)
def _free_card():
    yield
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _launches():
    return {k: v for k, v in _kernels.LAUNCHES.items() if v}


def _reset():
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()


def _quiet():
    log = logging.getLogger("ws3d_card_tests")
    if not log.handlers:
        log.addHandler(logging.NullHandler())
    log.propagate = False
    return log


def _fitted(cfg, device):
    """The two-stage model with the fitted npz, all or nothing."""
    model = build_model(cfg, device=device)
    assert bench.load_weights(model)[0] == "fitted"
    return model


def _rpn_flat():
    with np.load(WEIGHTS) as z:
        return {k: z[k] for k in z.files if k.split("/")[1] == "rpn"}


def _flat_model(cfg, flat, device="cuda"):
    model = build_model(cfg, device=device)
    load_flat(model, flat)
    return model


def _rpn_cfg(dtype="float32", dropout=True):
    cfg = load_config()
    cfg.TPU.COMPUTE_DTYPE = dtype
    if not dropout:
        cfg.RPN.DP_RATIO = 0.0
    return cfg


def _rpn_batches(n):
    """`n` stage-1 TRAIN batches of 16 scenes (host NumPy)."""
    src = SyntheticKitti(num_scenes=BATCH * 2, points_per_scene=20000, seed=3)
    return list(RPNDataset(src, _rpn_cfg(), mode="TRAIN", seed=0).batches(
        BATCH, steps=n, shuffle=True))


def _stage2_cfg(stage, dtype="float32"):
    cfg = load_config()
    configure(cfg, stage, STAGE2_POINTS)
    cfg.TPU.COMPUTE_DTYPE = dtype
    return cfg


def _stage2_batches(cfg, n):
    """`n` TRAIN batches of 800 crops from a synthetic proposal database."""
    db = synthetic_proposal_database(num=STAGE2_BATCH // 2, seed=0,
                                     crop_points=STAGE2_POINTS)
    return list(BoxPlaceDataset(db, cfg, mode="TRAIN", npoints=STAGE2_POINTS,
                                seed=0).batches(STAGE2_BATCH, steps=n))


def _train_setup(stage, dtype, device="cuda", dropout=True):
    """`stage`'s configuration in `dtype` and its model on `device`: stage 1
    with the fitted weights, stage 2 with the fitted trunk (an IOUN
    model's cascade keeps its seeded init: the fitted one is dead on these
    crops)."""
    if stage == "rpn":
        cfg = _rpn_cfg(dtype, dropout)
        return cfg, _flat_model(cfg, _rpn_flat(), device)
    cfg = _stage2_cfg(stage, dtype)
    return cfg, stage2_model(cfg, device)


def _trainer(model, cfg, stage="rpn"):
    return Trainer(model, cfg, total_steps=1000, stage=stage, seed=0,
                   log_fn=lambda msg: None)


def _gradients(model, cfg, stage, host, generator=None):
    """(loss, gradients, the net holding the BN statistics) of one step."""
    device = next(model.parameters()).device
    if stage == "rpn":
        loss, _, grads = rpn_gradients(
            model, cfg, batch_to_device(host, device), generator, 0.1,
            dict(model.rpn.named_parameters(prefix="rpn")))
        return loss, grads, model.rpn
    loss, _, grads = rcnn_gradients(
        model, cfg, stage, batch_to_device(host, device,
                                           step_inputs(stage, host)),
        generator, 0.1, trainable_parameters(model, stage))
    return loss, grads, model.rcnn


def _txt_rows(root):
    d = os.path.join(root, "final_result", "data")
    return {f: load_txt(os.path.join(d, f)) for f in sorted(os.listdir(d))}


def _eval_run(cfg, device, out_dir, scenes=BATCH, batch=BATCH, no_ap=True):
    """eval_auto's run_eval with the fitted npz on `scenes` synthetic
    scenes into `out_dir`: its stats."""
    src = SyntheticKitti(num_scenes=BATCH, points_per_scene=20000, seed=3)
    stats = {}
    run_eval(_fitted(cfg, device), cfg, src,
             RPNDataset(src, cfg, mode="EVAL", seed=0), _quiet(),
             scenes=scenes, batch=batch, output_dir=str(out_dir),
             no_ap=no_ap, stats=stats)
    return stats


# ------------------------------------------------------------ the library
def test_sass_instructions(card):
    """The fused SA routine (kernels 3, 2 and 9: modes 0, 1 and 2) has TF32
    HMMA only in each mode's 3xTF32 instance, bf16 HMMA
    (HMMA.1688.F32.BF16) only in its bf16 instance and in the rounded-layer
    instance of kernels 3 and 2; the weight-stationary route of kernels 2
    and 3 (fused_sa_resident_kernel, both bf16 precisions) has bf16 wgmma
    (HGMMA ... BF16) and no HMMA; no SIMT MLP routine (fused_sa_kernel) is
    left; each FPS cluster kernel has cluster barriers (UCGABAR)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_kernels.build())],
                          capture_output=True, text=True, check=True).stdout
    # (mangled name, HMMA, HGMMA and UCGABAR instructions) of each function
    funcs = [(p.split("\n", 1)[0], set(re.findall(
        r"\b(HG?MMA\.[\w.]+|UCGABAR_\w+)", p)))
        for p in sass.split("Function : ")[1:]]
    for mode in range(3):
        for prec, want in [(0, "TF32"), (1, "HMMA.1688.F32.BF16")] + (
                [(2, "HMMA.1688.F32.BF16")] if mode != 2 else []):
            # fused_sa_tc_kernel<mode, prec>: I L<type><mode>E L<type><prec>E E
            ops = [o for name, ops in funcs if re.search(
                rf"fused_sa_tc_kernelIL[a-z]+{mode}EL[a-z]+{prec}EE", name)
                for o in ops if o.startswith("HMMA")]
            assert ops and all(want in o for o in ops), (mode, prec, ops)
    res = [ops for name, ops in funcs if "fused_sa_resident_kernel" in name]
    assert len(res) == 2 and all(
        "HGMMA.64x64x16.F32.BF16" in ops and
        not any(o.startswith("HMMA") for o in ops) for ops in res), res
    assert not any("fused_sa_kernel" in name for name, _ in funcs)
    fps = [ops for name, ops in funcs if "fps_cluster_kernel" in name]
    assert fps and all(any(o.startswith("UCGABAR") for o in ops)
                       for ops in fps)


# ----------------------------------------------------- two-stage inference
@pytest.mark.parametrize("dtype,batch", [("float32", 16), ("bfloat16", 16),
                                         ("float32", 64), ("bfloat16", 64)])
def test_inference_kernel_calls(card, dtype, batch):
    """One batch through make_two_stage_fn with the fitted npz on
    tools.bench's inputs: every kernel call against its plain version,
    every kernel of the path called (in bf16 the bf16 and rounded-layer
    modes and no f32 mode), a finite packed record, no spill at batch 16.
    In bf16 at batch 16, kernel 9's bf16 mode on kernel 6's indices for
    each fused call is bit-equal to the fused kernel's bf16 mode and holds
    its plain version, directly and through its entry point; within
    BF16_GATE of the fused kernel where that took the weight-stationary
    route, which sums the same products by k16 (wgmma) where kernel 9 sums
    by k8."""
    cfg = bench.bench_config(dtype)
    fn = make_two_stage_fn(_fitted(cfg, "cuda"), cfg)
    pts = bench.input_batches(cfg, batch, 1, "cuda")[0]
    bf16 = dtype == "bfloat16"
    _reset()
    with Recorder(outputs=bf16 and batch == 16) as rec, torch.no_grad():
        out = fn(pts)
        torch.cuda.synchronize()
    launched = _launches()
    keys = check_calls(rec.calls)
    want = set(BF16_INFERENCE_KERNELS if bf16 else INFERENCE_KERNELS)
    assert want <= set(keys) and want <= set(launched), keys
    assert not (bf16 and set(F32_MODES) & set(launched)), launched
    packed, keep = out["packed"], out["keep"]
    assert tuple(packed.shape) == (batch, cfg.TPU.MAX_PROPOSALS, 9)
    # a score is -inf where the cascade did not run (never kept)
    assert bool(torch.isfinite(packed[..., 0:7]).all())
    assert bool(torch.isfinite(packed[..., 7][keep]).all())
    assert batch != 16 or int(out["spilled"]) == 0
    if not (bf16 and batch == 16):
        return
    calls = []
    with torch.no_grad():
        for (n, a, kw), o in zip(rec.calls, rec.outputs):
            if n != "fused_sa_cuda":
                continue
            xyz, feat, new_xyz, radius, nsample, kernels, biases, _ = a
            idx = ball_query.ball_query_multi_cuda([radius], [nsample], xyz,
                                                   new_xyz)[0]
            calls.append([xyz, feat, new_xyz, idx, kernels, biases])
            if kw.get("round_layers"):
                # kernel 9 has no rounded-layer mode: the same call in the
                # bf16 mode is its reference
                o = fused_sa.fused_sa_cuda(*a, **{**kw, "round_layers": False})
            given = fused_sa_idx.fused_sa_idx_cuda(*calls[-1], bf16=True)
            C = feat.shape[-1]
            if fused_sa.resident(C, nsample, 1, tuple(
                    [C + 3] + [int(k.shape[1]) for k in kernels])):
                assert within((given - o).abs().max().item(),
                              o.abs().max().item(), BF16_GATE)
            else:
                assert torch.equal(given, o)
            check_call("fused_sa_idx_cuda", calls[-1], {"bf16": True})
        _reset()
        for a in calls:
            fused_sa_idx.fused_sa_idx(*a, bf16=True)
    assert _kernels.LAUNCHES["fused_sa_idx_bf16"] == len(calls) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_scene_card_against_cpu(card, dtype):
    """One scene through make_two_stage_fn on the card and on the CPU (the
    plain versions): the same detections."""
    cfg = bench.bench_config(dtype)
    scene = bench.input_batches(cfg, 1, 1, "cpu")[0]
    with torch.no_grad():
        got = {k: v.cpu() for k, v in make_two_stage_fn(
            _fitted(cfg, "cuda"), cfg)(scene.cuda()).items()}
        ref = make_two_stage_fn(_fitted(cfg, "cpu"), cfg)(scene)
    check_detections(got, ref, float(cfg.IOUN.SCORE_THRESH))


# ------------------------------- the weight-stationary route of kernels 2, 3
# (radius, S, queries, widths past C + 3): the stage-2 SA0 and SA2 stacks;
# 254 = 31 x 8 + 6 and 31 = 15 x 2 + 1 queries leave a ragged last tile
RESIDENT_CASES = [(0.2, 16, 254, [128, 128, 128]),
                  (1.0, 64, 31, [128, 128, 256])]
RESIDENT_CROPS = 260        # 8,320 and 4,160 tiles: more than the SMs


def _crops(rng, B, P, C, device):
    """B crops of P z-sorted points with C features."""
    xyz = (rng.randn(B, P, 3) * 0.6).astype(np.float32)
    xyz = np.take_along_axis(xyz, np.argsort(xyz[..., 2], axis=1,
                                             kind="stable")[..., None], 1)
    feat = rng.randn(B, P, C).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (xyz, feat)]


def _he_mlp(rng, ci, widths, device):
    ks, bs = [], []
    for co in widths:
        ks.append(torch.from_numpy((rng.randn(ci, co) * math.sqrt(
            2.0 / ci)).astype(np.float32)).to(device))
        bs.append(torch.from_numpy((rng.randn(co) * 0.1).astype(
            np.float32)).to(device))
        ci = co
    return ks, bs


def _counted_call(*args, **kw):
    """fused_sa_cuda under a recording profiler: (out, fused_sa.resident
    counts)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fused_sa.fused_sa_cuda(*args, **kw)
        n = TRACE.totals()["counters"].get("fused_sa.resident", 0)
    return out, n


@pytest.mark.parametrize("window", [True, False], ids=["window", "full"])
@pytest.mark.parametrize("rounded", [False, True], ids=["bf16", "bf16r"])
def test_resident_route_against_plain(card, rounded, window):
    """Kernels 2 and 3 in both bf16 precisions at stage-2 widths on
    RESIDENT_CROPS crops of 512 points: the weight-stationary route taken
    and counted once a call, within BF16_GATE and BF16_MEAN_SHARE of the
    plain bf16 version (bf16-valued outputs in the rounded-layer mode), and
    bit-equal across two launches."""
    rng = np.random.RandomState(24)
    P, C = 512, 128
    xyz, feat = _crops(rng, RESIDENT_CROPS, P, C, card)
    prec = 2 if rounded else 1
    for radius, S, M, widths in RESIDENT_CASES:
        new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))]
        new_xyz = new_xyz.contiguous()
        ks, bs = _he_mlp(rng, C + 3, widths, card)
        assert fused_sa.resident(C, S, prec, tuple([C + 3] + widths))
        args = (xyz, feat, new_xyz, radius, S, ks, bs, window)
        kw = dict(bf16=True, round_layers=rounded)
        with torch.no_grad():
            got, n = _counted_call(*args, **kw)
            assert n == 1
            assert torch.equal(fused_sa.fused_sa_cuda(*args, **kw), got)
            ref = fused_sa.fused_sa_plain(xyz, feat, new_xyz, radius, S, ks,
                                          bs, True, rounded)
            f32 = fused_sa.fused_sa_plain(xyz, feat, new_xyz, radius, S, ks,
                                          bs)
        bf16_gate(got, ref, f32, f"S {S} widths {widths}")
        assert not rounded or torch.equal(got, got.bfloat16().float())


def test_resident_route_left_to_wide_stacks(card):
    """Stage 1's SA2 (259 -> 128 -> 196 -> 256) and SA3 (515 -> 256 -> 256
    -> 512) stacks in bf16 do not fit the route: they keep
    fused_sa_tc_kernel, count 0 and hold their plain version; nor does any
    3xTF32 call, at stage-2 widths too."""
    rng = np.random.RandomState(25)
    for C, widths, P, M, radius in [(256, [128, 196, 256], 1024, 256, 2.0),
                                    (512, [256, 256, 512], 256, 64, 4.0)]:
        xyz, feat = _crops(rng, 2, P, C, card)
        new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))]
        new_xyz = new_xyz.contiguous()
        ks, bs = _he_mlp(rng, C + 3, widths, card)
        for S in (16, 32):
            assert not fused_sa.resident(C, S, 1, tuple([C + 3] + widths))
            args = (xyz, feat, new_xyz, radius, S, ks, bs, True)
            with torch.no_grad():
                got, n = _counted_call(*args, bf16=True)
                ref = fused_sa.fused_sa_plain(xyz, feat, new_xyz, radius, S,
                                              ks, bs, True)
                f32 = fused_sa.fused_sa_plain(xyz, feat, new_xyz, radius, S,
                                              ks, bs)
            assert n == 0
            bf16_gate(got, ref, f32, f"C {C} S {S}")
    for radius, S, M, widths in RESIDENT_CASES:
        assert not fused_sa.resident(128, S, 0, tuple([131] + widths))


def test_window_kernels_on_inference_inputs(card):
    """Kernels 10 and 8 on the f32 batch's crop and FP inputs: kernel 10 at
    z_window 32, 1 and every tile bit-equal to kernel 5 and its plain
    version, kernel 8 to kernel 4, its neighbours kernel 7's. Through their
    entry points: crop_gather(z_window=32) launches kernel 10 once, the FP
    modules with sorted_points=True kernel 8 once each, the RPN outputs
    within 1e-5."""
    cfg = bench.bench_config("float32")
    model = _fitted(cfg, "cuda")
    pts = bench.input_batches(cfg, BATCH, 1, "cuda")[0]
    only = ("crop_gather_cuda", "three_interpolate_cuda")
    with Recorder(only=only) as rec, torch.no_grad():
        make_two_stage_fn(model, cfg)(pts)
    crop = [a for n, a, _ in rec.calls if n == "crop_gather_cuda"][0][:6]
    fp = [a[:3] for n, a, _ in rec.calls if n == "three_interpolate_cuda"]
    ref = crop_gather.crop_gather_cuda(*crop)                   # kernel 5
    for W in (32, 1, pts.shape[1] // crop_gather.TILE):
        got = crop_gather.crop_gather_cuda(*crop, W)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), W
        check_call("crop_gather_cuda", [*crop, W], {})
    for a in fp:
        check_call("three_interpolate_window_cuda", list(a), {})
    _reset()
    got = crop_gather.crop_gather(*crop, z_window=32,
                                  center_z=crop[2][..., 1].contiguous())
    assert _launches().get("crop_gather_window") == 1
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    fps = [m for name, m in model.rpn.backbone.named_children()
           if name.startswith("fp_")]
    with torch.no_grad():
        want = model.rpn_forward({"pts_input": pts})
        for m in fps:
            m.sorted_points = True
        _reset()
        out = model.rpn_forward({"pts_input": pts})
        torch.cuda.synchronize()
    assert _kernels.LAUNCHES["three_interpolate_window"] == len(fps) == \
        len(fp) == 4
    for key in ("rpn_cls", "rpn_reg"):
        err = (out[key] - want[key]).abs().max().item()
        assert err <= 1e-5 * want[key].abs().max().item(), key


def test_eval_auto_on_card(card, tmp_path):
    """eval_auto's run_eval on 16 scenes at batch 16 (f32, the fitted npz):
    every inference kernel launched, a detection, the AP of the native
    library's path and of the NumPy path within 1e-6, the first scene's
    txt file the CPU's (the plain versions) within 1e-3. Then in bf16 (the
    BN-free stacks' eval in the rounded-layer mode) against f32 by
    diff_detections: at most 4 detections unmatched, the matched ones
    within 0.05 m (centre, dims) and 0.02 (score) on average."""
    from ws3d_tpu_torch import native
    from ws3d_tpu_torch.eval.kitti_ap import get_official_eval_result
    from ws3d_tpu_torch.tools.diff_detections import diff
    cfg = bench.bench_config("float32")
    _reset()
    stats = _eval_run(cfg, "cuda", tmp_path / "f32", no_ap=False)
    assert set(INFERENCE_KERNELS) <= set(_launches())
    assert stats["detections"] > 0 and native.available()
    ap = [get_official_eval_result(*stats["annos"], cfg.CLASSES,
                                   native=n)[1] for n in (True, False)]
    assert ap[0].keys() == ap[1].keys()
    assert max(abs(float(ap[0][k]) - float(ap[1][k])) for k in ap[0]) <= 1e-6
    _eval_run(cfg, "cpu", tmp_path / "cpu", scenes=1, batch=1)
    name, rows = next(iter(_txt_rows(tmp_path / "cpu").items()))
    check_txt(_txt_rows(tmp_path / "f32")[name], rows,
              float(cfg.IOUN.SCORE_THRESH))
    _eval_run(bench.bench_config("bfloat16"), "cuda", tmp_path / "bf16")
    d = diff(*(str(tmp_path / n / "final_result" / "data")
               for n in ("bf16", "f32")))
    assert d["matched"] > 0 and d["only_a"] + d["only_b"] <= 4, d
    assert max(d["center_m"]["mean"], d["dims_m"]["mean"]) <= 0.05, d
    assert d["score"]["mean"] <= 0.02, d


def test_eval_active_on_card(card, tmp_path):
    """eval_active's run_active at its defaults (16 scenes, 16,384 points,
    batch 8): kernel 5 in its `s % cnt` mode on these unsorted scenes, the
    calls against their plain versions, the path's kernels launched, a
    detection; one scene's batch on the card and the CPU: equal keep
    masks, kept boxes and scores within 1e-3."""
    from ws3d_tpu_torch.tools import eval_active
    cfg = bench.bench_config("float32")
    model = _fitted(cfg, "cuda")
    src = SyntheticKitti(num_scenes=BATCH, points_per_scene=20000, seed=3)
    stats = {}
    _reset()
    with Recorder() as rec:
        eval_active.run_active(model, cfg, src, _quiet(), scenes=BATCH,
                               batch=8, max_points=16384, seed=0,
                               output_dir=str(tmp_path), stats=stats)
        torch.cuda.synchronize()
    assert {"crop_gather", "fps", "fused_sa_window", "fused_sa_full",
            "greedy_sweep"} <= set(_launches())
    assert stats["detections"] > 0
    assert {kw.get("grouped", a[5] if len(a) > 5 else True)
            for n, a, kw in rec.calls if n == "crop_gather_cuda"} == {False}
    check_calls(rec.calls)
    scene = src.get_scene(src.sample_ids[0], with_noise=True)
    entry = eval_active.scene_entry(scene, cfg, 16384, 0)
    V = eval_active.pick_v_bucket(int(entry[3].sum()), entry[3].size)
    outs = []
    for m in (model, _fitted(cfg, "cpu")):
        dev = next(m.parameters()).device
        with torch.no_grad():
            outs.append(eval_active.infer_batch(m, cfg, *(
                torch.from_numpy(a[None]).to(dev) for a in entry), V)[0]
                .cpu())
    keep = [o[0, :, 8] > 0.5 for o in outs]
    assert torch.equal(keep[0], keep[1])
    assert not bool(keep[0].any()) or float(
        (outs[0][0, keep[0], 0:8] - outs[1][0, keep[0], 0:8]).abs().max()
    ) <= 1e-3


def test_no_intensity_attention_batch(card):
    """An inference batch of 16 with RPN.USE_INTENSITY=False (3-channel
    scenes: SA0 runs the ball query, kernel 6, not a fused kernel) and
    ATTENTION=True, from seeded weights: every kernel call, kernel 6's
    among them, against its plain version, every inference kernel and the
    ball query launched, a finite record of the batch's shape."""
    cfg = bench.bench_config("float32")
    cfg.RPN.USE_INTENSITY = False
    cfg.ATTENTION = True
    pts = bench.input_batches(cfg, BATCH, 1, "cuda")[0]
    assert pts.shape[-1] == 3
    fn = make_two_stage_fn(build_model(cfg, seed=0), cfg)
    _reset()
    with Recorder() as rec, torch.no_grad():
        out = fn(pts)
        torch.cuda.synchronize()
    assert set(INFERENCE_KERNELS + ("ball_query",)) <= set(_launches())
    assert "ball_query" in check_calls(rec.calls)
    packed = out["packed"]
    assert tuple(packed.shape) == (BATCH, cfg.TPU.MAX_PROPOSALS, 9)
    assert bool(torch.isfinite(packed[..., 0:7]).all())


# ------------------------------------------------------------ training
def _interpolate_backward(calls):
    """The interpolation's backward (kernel 7 and index_add_) against
    autograd through its plain forward, on each recorded forward call's
    inputs: the same weighted sums, added by atomics in another order."""
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, args, _ in calls:
        if name != "three_interpolate_cuda":
            continue
        unknown, known, feats = args[:3]
        cot = torch.randn(unknown.shape[:2] + feats.shape[2:], device="cuda",
                          generator=g)
        f1, f2 = (feats.clone().requires_grad_(True) for _ in range(2))
        (interpolate.interpolate_features(unknown, known, f1)
         * cot).sum().backward()
        (interpolate.three_interpolate_plain(unknown, known, f2)
         * cot).sum().backward()
        assert (f1.grad - f2.grad).abs().max() <= \
            1e-5 * f2.grad.abs().max() + 1e-6


def _given_index_paths(calls, outputs):
    """An RCNN step's calls (FPS, the fused SA, the backward's ball query,
    3 each): kernel 9 on kernel 6's indices bit-equal to the fused kernel
    and within its gate, then through fused_sa_single_scale (one launch a
    call, finite gradients); the FusedSA backward against autograd through
    the plain forward (its gather's backward adds in another order)."""
    names = [c[0] for c in calls]
    assert {k: names.count(k) for k in set(names)} == {
        "fps_cuda": 3, "fused_sa_cuda": 3, "ball_query_multi_cuda": 3}
    fused = [(a, o) for (n, a, _), o in zip(calls, outputs)
             if n == "fused_sa_cuda"]
    given = []
    for (n, a, _), o in zip(calls, outputs):
        if n != "ball_query_multi_cuda":
            continue
        (radius,), (nsample,), xyz, new_xyz = a
        match = [(fa, fo) for fa, fo in fused
                 if (fa[3], fa[4]) == (radius, nsample)
                 and torch.equal(fa[0], xyz) and torch.equal(fa[2], new_xyz)]
        assert len(match) == 1
        (_, feat, _, _, _, kernels, biases, _), fo = match[0]
        given.append([xyz, feat, new_xyz, o[0], kernels, biases])
        with torch.no_grad():       # the same rows through the same routine
            assert torch.equal(fused_sa_idx.fused_sa_idx_cuda(*given[-1]),
                               fo)
            check_call("fused_sa_idx_cuda", given[-1], {})
    _reset()
    for xyz, feat, new_xyz, idx, kernels, biases in given:
        leaves = [x.clone().requires_grad_(True)
                  for x in (feat, *kernels, *biases)]
        L = len(kernels)
        out = fused_sa_idx.fused_sa_single_scale(
            xyz, leaves[0], new_xyz, idx, leaves[1:1 + L], leaves[1 + L:])
        assert all(bool(torch.isfinite(g).all())
                   for g in torch.autograd.grad(out.sum(), leaves))
    assert _kernels.LAUNCHES["fused_sa_idx"] == len(given) == 3
    g = torch.Generator(device="cuda").manual_seed(7)
    for (xyz, feat, new_xyz, radius, nsample, kernels, biases, window), fo \
            in fused:
        cot = torch.randn(fo.shape, device="cuda", generator=g)
        grads = []
        for fn in (lambda *x: fused_sa.fused_sa_train(*x, window),
                   fused_sa.fused_sa_plain):
            leaves = [x.clone().requires_grad_(True)
                      for x in (xyz, feat, new_xyz, *kernels, *biases)]
            L = len(kernels)
            out = fn(*leaves[:3], radius, nsample, leaves[3:3 + L],
                     leaves[3 + L:])
            grads.append(torch.autograd.grad((out * cot).sum(), leaves))
        for a, b in zip(*grads):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max(), window


@pytest.mark.parametrize("stage,dtype", TRAIN_CASES)
def test_train_step_on_card(card, stage, dtype):
    """A train step at full width (16 scenes of 16,384 points; 800 crops
    of 512 points): every kernel call of one step against its plain
    version (stage 1 in f32 also the interpolation's backward, RCNN in f32
    _given_index_paths). Then two steps through Trainer.train_steps: finite
    losses, f32 state; stage 1 launches FPS and kernels 4, 6 and 7, in f32
    34 of each BatchNorm + ReLU kernel a step and moves the BN statistics;
    stage 2 launches exactly STAGE2_STEP_LAUNCHES a step (bf16: in the
    rounded-layer mode) and leaves what it does not train bit-unchanged;
    no bf16 path launches an f32 or eval mode."""
    cfg, model = _train_setup(stage, dtype)
    host = (_rpn_batches(2) if stage == "rpn"
            else _stage2_batches(cfg, 2))
    trainer = _trainer(model, cfg, stage)
    bf16 = dtype == "bfloat16"
    given = (stage, dtype) == ("rcnn", "float32")
    with Recorder(outputs=given) as rec:
        _gradients(model, cfg, stage, host[0], trainer.generator)
        torch.cuda.synchronize()
    keys = check_calls(rec.calls)
    if stage == "rpn":
        assert {"fps", "ball_query", "three_nn"} <= set(keys), keys
        assert all(keys[k] == BN_LAYERS for k in BN_KERNELS), keys
        if not bf16:
            _interpolate_backward(rec.calls)
    if given:
        _given_index_paths(rec.calls, rec.outputs)
    del rec
    before = {k: v.clone() for k, v in model.state_dict().items()
              if k not in trainer.optimizer.params}
    _reset()
    hist = trainer.train_steps(host, total_steps=2, log_every=1,
                               prefetch_size=0)
    launched = _launches()
    assert all(math.isfinite(h["loss"]) for h in hist) and trainer.step == 2
    state = model.state_dict()
    assert all(t.dtype == torch.float32 for t in state.values()
               if t.is_floating_point())
    assert not (bf16 and set(F32_MODES + ("fused_sa_window_bf16",
                                          "fused_sa_full_bf16"))
                & set(launched)), launched
    if stage == "rpn":
        interp = "three_interpolate_bf16" if bf16 else "three_interpolate"
        assert {"fps", interp, "ball_query", "three_nn"} <= set(launched)
        if not bf16:
            assert all(launched[k] == 2 * BN_LAYERS for k in BN_KERNELS)
            assert not any(torch.equal(v, state[k])
                           for k, v in before.items()
                           if k.endswith((".mean", ".var")))
        return
    assert launched == {
        k + ("_bf16r" if bf16 and k.startswith("fused_sa") else ""): 2 * v
        for k, v in STAGE2_STEP_LAUNCHES[stage].items()}
    assert all(torch.equal(state[k], v) for k, v in before.items())


@pytest.mark.parametrize("stage,dtype", TRAIN_CASES)
def test_step_card_against_cpu(card, stage, dtype):
    """One step of `stage` on a small batch (2 scenes, 8 crops) on the card
    and on the CPU (the plain versions) from the same weights and batch,
    no dropout. In f32 the loss and every gradient within 1e-3. In bf16,
    with one f32 step on the CPU beside them: finite losses, f32
    gradients, the median per-tensor gap of the card's gradients to the
    CPU's below BF16_GRAD_MEDIAN and below half the CPU's bf16-vs-f32
    median gap, BN statistics within BF16_BN_TOL."""
    if stage == "rpn":
        host = {k: v[:2] for k, v in _rpn_batches(1)[0].items()
                if k in RPN_INPUTS}
    else:
        host = {k: v[:8] for k, v in
                _stage2_batches(_stage2_cfg(stage), 1)[0].items()}
    runs = [(dtype, "cuda"), (dtype, "cpu")] + (
        [("float32", "cpu")] if dtype == "bfloat16" else [])
    got = []
    for dt, device in runs:
        cfg, model = _train_setup(stage, dt, device, dropout=False)
        loss, grads, net = _gradients(model, cfg, stage, host)
        assert {g.dtype for g in grads.values()} == {torch.float32}
        got.append((float(loss), {k: g.cpu() for k, g in grads.items()},
                    {k: v.cpu() for k, v in net.state_dict().items()
                     if k.endswith((".mean", ".var"))}))
    (gl, gg, gs), (cl, cg, cs) = got[:2]
    assert math.isfinite(gl) and math.isfinite(cl)
    if dtype == "float32":
        assert abs(gl - cl) <= 1e-3 * abs(cl)
        for k, g in cg.items():
            # a zero CPU gradient wants an exactly zero card gradient
            err = (gg[k] - g).abs().max().item()
            assert err <= 1e-3 * g.abs().max().item(), (stage, k, err)
        return
    keys = [k for k in cg if cg[k].abs().max() > 0]
    card_gap = float(np.median([gap(gg[k], cg[k]) for k in keys]))
    own_gap = float(np.median([gap(cg[k], got[2][1][k]) for k in keys]))
    assert card_gap <= BF16_GRAD_MEDIAN[stage], card_gap
    assert card_gap <= 0.5 * own_gap, (card_gap, own_gap)
    assert max((gap(gs[k], cs[k]) for k in cs), default=0.0) <= BF16_BN_TOL


def test_bench_train_rpn_kernel_calls(card):
    """tools.bench_train's stage-1 step at batch 25 (its seeded model and
    batch): every kernel call against its plain version, FPS, kernels 4, 6
    and 7 and the BatchNorm + ReLU kernels among them."""
    from ws3d_tpu_torch.tools import bench_train
    b = bench_train.rpn_bench(load_config(), 25, "cuda")
    with Recorder() as rec:
        b.gradients(b.batch, b.generator)
        torch.cuda.synchronize()
    del b
    assert set(TRAIN_KERNELS + BN_KERNELS) <= set(check_calls(rec.calls))


@pytest.mark.parametrize("stage", ["rpn", "rcnn"])
def test_train_with_validation(card, stage, tmp_path):
    """3 steps of Trainer.train_steps, validated every 2 steps and after
    the last: stage 1 at batch 16 with the GT-database augmentation on 8
    EVAL scenes, RCNN at 800 crops on a held-out tenth of a database.
    Finite losses, a checkpoint per eval and the best one, the generator
    state and every parameter and buffer bit-equal across each
    validation, the first validation's kernel calls against their plain
    versions."""
    from ws3d_tpu_torch.datasets.gt_database import build_gt_database
    from ws3d_tpu_torch.training import make_val_fn
    cfg, model = _train_setup(stage, "float32")
    if stage == "rpn":
        src = SyntheticKitti(num_scenes=BATCH, points_per_scene=20000, seed=3)
        host = list(RPNDataset(
            src, cfg, mode="TRAIN", seed=0,
            gt_database=build_gt_database(src, src.sample_ids)).batches(
            BATCH, steps=3, shuffle=True))
        val = RPNDataset(SyntheticKitti(num_scenes=8, points_per_scene=18000,
                                        seed=1000), cfg, mode="EVAL", seed=0)
        inner = make_val_fn(cfg, stage, lambda: val.batches(8))
        want = {"fps", "three_interpolate"}
    else:
        train_db, val_db = split_database(synthetic_proposal_database(
            num=STAGE2_BATCH // 2, seed=0, crop_points=STAGE2_POINTS), 0.1)
        host = list(BoxPlaceDataset(train_db, cfg, mode="TRAIN",
                                    npoints=STAGE2_POINTS, seed=0).batches(
            STAGE2_BATCH, steps=3))
        val = BoxPlaceDataset(val_db, cfg, mode="EVAL", npoints=STAGE2_POINTS,
                              seed=0)
        inner = make_val_fn(cfg, stage, lambda: val.batches(
            len(val), steps=1, shuffle=False))
        want = {"fps", "fused_sa_window", "fused_sa_full"}
    trainer = _trainer(model, cfg, stage)
    rec, evals = Recorder(), []

    def snapshot():
        return [trainer.generator.get_state()] + [
            v.clone() for v in trainer.model.state_dict().values()]

    def val_fn(m):
        before = snapshot()
        with rec if not evals else contextlib.nullcontext():
            evals.append(inner(m))
        after = snapshot()
        assert len(before) == len(after)
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        return evals[-1]
    hist = trainer.train_steps(host, total_steps=3, log_every=1,
                               prefetch_size=0, ckpt_dir=str(tmp_path),
                               val_fn=val_fn, val_every=2)
    assert len(hist) == 3 and all(math.isfinite(h["loss"]) for h in hist)
    assert len(evals) == 2
    assert sorted(f for f in os.listdir(tmp_path)
                  if f.startswith(f"{stage}_ckpt_")) == [
        f"{stage}_ckpt_{k}.pt" for k in ("best", "e1", "e2")]
    assert want <= set(check_calls(rec.calls))


# ------------------------------------------------------ proposal database
def test_proposal_database(card):
    """tools/generate_box_dataset's device stage and host loop on 16 whole
    scenes of 16,384 points (K 64, max_crop 2048, threshold 0.1): one
    kernel-6w launch a scene, each against its plain version, the path's
    kernels launched, finite records, the first scene's the CPU's within
    1e-5; an RCNN step on 64 crops of the database, a finite loss."""
    from ws3d_tpu_torch.tools.generate_box_dataset import (BENCH_WEIGHTS,
                                                           load_rpn,
                                                           propose_and_crop,
                                                           scene_records)
    cfg = load_config()

    def scene(model, sample, device, database_len=0):
        with torch.no_grad():
            out = propose_and_crop(
                model, cfg, torch.from_numpy(sample["pts_input"]).to(device),
                torch.from_numpy(sample["valid"]).to(device),
                score_thresh=0.1, max_proposals=64, max_crop=2048)
        return scene_records(sample, *[o.cpu().numpy() for o in out], 2048,
                             database_len)[0]
    model = load_rpn(cfg, "cuda", [BENCH_WEIGHTS])
    ds = RPNDataset(SyntheticKitti(num_scenes=BATCH, points_per_scene=18000,
                                   seed=0), cfg, mode="EVAL", seed=0)
    samples = [ds.get_whole_scene(i, max_points=int(cfg.RPN.NUM_POINTS))
               for i in range(BATCH)]
    scene(model, samples[0], "cuda")                         # warm-up
    database = []
    _reset()
    with Recorder(only=("ball_query_wrap_cuda",)) as rec:
        for s in samples:
            database += scene(model, s, "cuda", len(database))
        torch.cuda.synchronize()
    launched = _launches()
    assert launched["ball_query_wrap"] == len(rec.calls) == BATCH
    assert {"fps", "fused_sa_window", "fused_sa_full", "three_interpolate",
            "greedy_sweep"} <= set(launched)
    check_calls(rec.calls)
    assert database and all(np.isfinite(r["cur_box_point"]).all()
                            and r["cur_box_point"].shape[0] > 5
                            for r in database)
    check_records(scene(model, samples[0], "cuda"),
                  scene(load_rpn(load_config(), "cpu", [BENCH_WEIGHTS]),
                        samples[0], "cpu"))
    cfg2, model2 = _train_setup("rcnn", "float32")
    trainer = _trainer(model2, cfg2, "rcnn")
    batch = next(BoxPlaceDataset(database, cfg2, mode="TRAIN",
                                 npoints=STAGE2_POINTS, seed=0).batches(
        64, steps=1))
    aux = trainer.step_fn(batch_to_device(batch, "cuda",
                                          step_inputs("rcnn", batch)),
                          trainer.generator, trainer.bn_sched(0))
    assert math.isfinite(float(aux["loss"]))


# ------------------------------------------------------------- the tools
def test_pointnet2_seg_steps(card):
    """tools/pointnet2_seg at its defaults (4,096 points, batch 4, the
    seeded init): one step's kernel calls (FPS, the ball query, the
    interpolation and, in its backward, the 3-NN search) against their
    plain versions, then two steps with finite Dice losses and all four
    kernels launched."""
    from ws3d_tpu_torch.models.detector import init_random
    from ws3d_tpu_torch.tools import pointnet2_seg as seg
    cfg = load_config()
    seg.configure(cfg, 4096)
    ds = RPNDataset(SyntheticKitti(num_scenes=16, points_per_scene=18000,
                                   seed=0), cfg, mode="EVAL", npoints=4096,
                    seed=0)
    batches = [(torch.from_numpy(b["pts_input"]).cuda(),
                torch.from_numpy(b["label"]).cuda())
               for _, b in zip(range(3), seg.seg_batches(ds, 4))]
    net = init_random(seg.SegNet(cfg), 0).cuda()
    opt = seg.make_optimizer(net, 0.002)
    with Recorder() as rec:
        seg.train_step(net, opt, *batches[0])
        torch.cuda.synchronize()
    assert set(TRAIN_KERNELS) <= set(check_calls(rec.calls))
    _reset()
    assert all(math.isfinite(float(seg.train_step(net, opt, *b)))
               for b in batches[1:])
    assert set(TRAIN_KERNELS) <= set(_launches())


def test_gpu_selftest(card):
    """ws3d_tpu_torch.tools.gpu_selftest: every kernel against its plain
    version at tools/tpu_selftest.py's shapes and beside them."""
    from ws3d_tpu_torch.tools import gpu_selftest
    assert gpu_selftest.run() == 0


def test_bench_tools(card):
    """tools.bench's main at its defaults (batch 64, bf16) and the same
    loop in f32: the path's kernels launched, parseable lines (the whole
    npz overlaid, a detection, a finite rate); `tools.bench_train --split
    --reps 2`: a line a stage with finite positive times."""
    out = io.StringIO()
    _reset()
    with contextlib.redirect_stdout(out):
        bench.main()
    assert set(BF16_INFERENCE_KERNELS) <= set(_launches())
    line = json.loads(out.getvalue().splitlines()[-1])
    total = line["weights_overlaid"].split("/")
    assert line["weights"] == "fitted" and total[0] == total[1] != "0"
    assert line["detections_last_batch"] > 0
    assert line["batch"] == bench.DEFAULT_BATCH
    assert line["kitti_dump"] == "overlapped"
    _reset()
    f32 = bench.run(bench.bench_config("float32"), batch=bench.DEFAULT_BATCH)
    assert set(INFERENCE_KERNELS) <= set(_launches())
    assert all(math.isfinite(r["value"]) and r["value"] > 0
               for r in (line, f32))
    torch.cuda.empty_cache()
    run = subprocess.run([sys.executable, "-m",
                          "ws3d_tpu_torch.tools.bench_train", "--split",
                          "--reps", "2"], cwd=REPO, capture_output=True,
                         text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    records = [json.loads(x) for x in run.stdout.splitlines()
               if x.startswith("{")]
    assert [r["stage"] for r in records] == ["rpn", "rcnn", "ioun"]
    assert all(math.isfinite(r[k]) and r[k] > 0 for r in records
               for k in ("device_ms_per_step", "fwd_ms", "bwd_ms"))


# ------------------------------------------------------------- scale-out
STEP_KEYS = ("pts_input", "rpn_cls_label", "rpn_reg_label")


def test_scaleout_nccl_world1(card, tmp_path):
    """One NCCL rank through parallel.launch, deterministic: the
    data-parallel stage-1 Trainer over two batches of 16 within 1e-5 of
    the plain one; the global-batch step (data_parallel_jit) bit-equal to
    the plain step; eval_auto's run_eval on 16 scenes the single run's
    files within 1e-3. Each launches its path's kernels, the steps 34 of
    each BatchNorm + ReLU kernel a step."""
    from torch_parallel_ranks import (card_rank, eval_rank, global_rank,
                                      trainer_rank)
    cfg, flat, host = _rpn_cfg(), _rpn_flat(), _rpn_batches(2)
    gcfg = _rpn_cfg(dropout=False)
    step_batch = {k: host[0][k] for k in STEP_KEYS}
    ecfg = bench.bench_config("float32")
    tw, gl, ev = launch(card_rank, 1, [
        (trainer_rank, (cfg, flat, host), True),
        (global_rank, ({"rpn": (gcfg, "rpn", flat, step_batch)},), True),
        (eval_rank, (ecfg, str(tmp_path / "mesh1")), False)],
        device="cuda", timeout=900)[0]
    model = _flat_model(cfg, flat)
    trainer = _trainer(model, cfg)
    with deterministic():
        trainer.train_steps(host, total_steps=2, log_every=1,
                            prefetch_size=0)
        single = one_step(gcfg, "rpn", _flat_model(gcfg, flat), step_batch)
    assert tw["out"]["step"] == trainer.step == 2
    assert max_diff(tw["out"]["state"], cpu_state(model)) <= 1e-5
    for r in (tw, gl):      # gl: the global step and the per-rank step
        assert all(r["launches"][k] for k in TRAIN_KERNELS)
        assert all(r["launches"][k] == 2 * BN_LAYERS for k in BN_KERNELS)
    state, aux, grads = gl["out"]["rpn"]["jit"]
    assert max_diff(state, single[0]) == 0.0
    assert aux["loss"] == single[1]["loss"]
    assert all(torch.equal(grads[k], v) for k, v in single[2].items())
    n_single = _eval_run(ecfg, "cuda", tmp_path / "one")["detections"]
    a, b = _txt_rows(tmp_path / "one"), _txt_rows(tmp_path / "mesh1")
    assert a.keys() == b.keys()
    for name in a:
        assert len(a[name]) == len(b[name]), name
        check_txt(a[name], b[name], float(ecfg.IOUN.SCORE_THRESH))
    assert ev["out"] == n_single > 0
    assert all(ev["launches"][k] for k in INFERENCE_KERNELS)


def test_scaleout_two_gloo_ranks(card):
    """Two gloo ranks sharing cuda:0 (DP_RATIO 0, the steps deterministic).
    The stage-1 step at batch 16 and the IOUN step at 800 crops: on
    identical shards within 1e-5 of the single step on one shard, on the
    whole batch the loss within 5 % (IOUN 15 %) of the single step's,
    replicas bit-equal, the IOUN trunk unchanged. The global-batch stage-1
    step against the single step: replicas bit-equal, the loss and every
    BN statistic within 1e-5, the gradients within the GLOBAL_GRAD_*
    gates. A batch of 16 through data_parallel_infer, the stage-2 budget
    pooled: the single batch's kept slots, packed rows within 1e-3, n_live
    and no spill. Each rank launches each path's kernels."""
    from torch_parallel_ranks import (card_rank, global_rank, infer_rank,
                                      train_rank)
    icfg = _stage2_cfg("ioun")
    cfgs = {"rpn": _rpn_cfg(dropout=False), "ioun": icfg}
    flats = {"rpn": _rpn_flat(), "ioun": to_flat(stage2_model(icfg, "cpu"))}
    hosts = {"rpn": {k: v for k, v in _rpn_batches(1)[0].items()
                     if k in STEP_KEYS},
             "ioun": _stage2_batches(icfg, 1)[0]}
    per = {s: len(next(iter(h.values()))) // 2 for s, h in hosts.items()}
    ecfg = bench.bench_config("float32")
    pts = bench.input_batches(ecfg, BATCH, 1, "cpu")[0].numpy()
    ranks = launch(card_rank, 2, [
        (train_rank, (cfgs[s], s, flats[s], hosts[s], per[s]), True)
        for s in ("rpn", "ioun")] + [
        (global_rank, ({"rpn": (cfgs["rpn"], "rpn", flats["rpn"],
                                hosts["rpn"])},), True),
        (infer_rank, ({"f32": (ecfg, pts)}, None), False)],
        backend="gloo", device="cuda:0", timeout=900)
    kernels = {"rpn": TRAIN_KERNELS, "ioun": tuple(STAGE2_STEP_LAUNCHES[
        "ioun"])}
    for i, (s, bound) in enumerate((("rpn", 0.05), ("ioun", 0.15))):
        with deterministic():
            shard = one_step(cfgs[s], s, _flat_model(cfgs[s], flats[s]),
                             {k: v[:per[s]] for k, v in hosts[s].items()})
            whole = one_step(cfgs[s], s, _flat_model(cfgs[s], flats[s]),
                             hosts[s])
        r0, r1 = ranks[0][i]["out"], ranks[1][i]["out"]
        assert max_diff(r0["tiled"][0], shard[0]) < 1e-5, s
        loss, ref = r0["full"][1]["loss"], whole[1]["loss"]
        assert math.isfinite(loss) and abs(loss - ref) < bound * abs(ref), s
        assert max_diff(r0["tiled"][0], r1["tiled"][0]) == 0.0, s
        assert max_diff(r0["full"][0], r1["full"][0]) == 0.0, s
        if s == "ioun":
            m = _flat_model(icfg, flats[s])
            trained = set(trainable_parameters(m, s))
            assert all(torch.equal(v, r0["full"][0][k])
                       for k, v in cpu_state(m).items() if k not in trained)
        assert all(r[i]["launches"][k] for r in ranks for k in kernels[s]), s
    with deterministic():
        rpn = (cfgs["rpn"], "rpn")
        single = one_step(*rpn, _flat_model(cfgs["rpn"], flats["rpn"]),
                          hosts["rpn"])
        with split_bn_sums():
            split = one_step(*rpn, _flat_model(cfgs["rpn"], flats["rpn"]),
                             hosts["rpn"])
    g0, g1 = (r[2]["out"]["rpn"]["jit"] for r in ranks)
    assert max_diff(g0[0], g1[0]) == 0.0 and g0[1]["loss"] == g1[1]["loss"]
    ref_loss = single[1]["loss"]
    assert abs(g0[1]["loss"] - ref_loss) <= 1e-5 * abs(ref_loss)
    for k, v in single[0].items():
        if k.endswith((".mean", ".var")):
            d = (g0[0][k] - v).abs()
            assert not bool((d > 1e-5 * v.abs() + 1e-5 * v.abs().max())
                            .any()), k
    worst, median = grad_gaps(g0[2], single[2])
    bound = min(max(GLOBAL_GRAD_FACTOR * grad_gaps(split[2], single[2])[0],
                    GLOBAL_GRAD_WORST_FLOOR), GLOBAL_GRAD_WORST)
    assert worst <= bound and median <= GLOBAL_GRAD_MEDIAN, (worst, median)
    for r in ranks:         # the global step and the per-rank step
        assert all(r[2]["launches"][k] for k in TRAIN_KERNELS)
        assert all(r[2]["launches"][k] == 2 * BN_LAYERS for k in BN_KERNELS)
    with torch.no_grad():
        ref = make_two_stage_fn(_fitted(ecfg, "cuda"), ecfg)(
            torch.from_numpy(pts).cuda())
    got = ranks[0][3]["out"]["f32"]
    assert all(torch.equal(v, ranks[1][3]["out"]["f32"][k])
               for k, v in got.items())
    keep = got["keep"]
    assert torch.equal(keep, ref["keep"].cpu()) and bool(keep.any())
    assert float((got["packed"][keep] - ref["packed"].cpu()[keep]).abs()
                 .max()) < 1e-3
    assert int(got["n_live"]) == int(ref["n_live"])
    assert int(got["spilled"]) == int(ref["spilled"]) == 0
    assert all(r[3]["launches"][k] for r in ranks for k in INFERENCE_KERNELS)
