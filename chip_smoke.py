#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from ws3d_tpu_torch/csrc (nvcc, sm_90a); print
     each kernel's registers and spills, and require TF32 tensor-core
     instructions (HMMA) in all three modes of the fused SA routine (kernels
     2, 3 and 9), no SIMT MLP routine (fused_sa_kernel), and cluster
     barriers (UCGABAR) in the FPS cluster kernel (cuobjdump -sass);
  2. run the two-stage pipeline once on a batch of the main path (16
     scenes), record every kernel call it makes, and hold each kernel
     against its plain PyTorch version on the recorded inputs (indices
     exact, floats within the stated tolerance), with CUDA-event times, the
     plain version's time and a roofline bound (the fused SA's: 3x its MLP
     FLOPs at the TF32 tensor-core peak; kernel 4's: the pairs inside each
     query's z window on z-sorted clouds, with the dense bound beside it;
     kernel 5's: the points of each centre's z slab, with the dense bound
     and its device time queued behind a sleep kernel beside it);
     print the time and the launch layout (gather, Q, Sp, KC, warps, shared
     memory) of each launch of kernels 2 and 3, the time of each launch of
     kernel 4, kernel 4 on FP0's inputs shuffled and kernel 5 on the first
     scene's points shuffled (nothing to prune; each held against its plain
     version, kernel 5 exactly) and FPS's time per row class;
  3. the inference path: 16 synthetic scenes at full width with the fitted
     weights (ws3d_tpu/data/bench_weights.npz) through make_two_stage_fn,
     one warm-up and timed batches closed by torch.cuda.synchronize();
     every kernel of the path must be launched during this run; then one
     batch under torch.profiler;
  4. one scene through the port on the GPU and on the CPU (the plain
     versions); the detections must agree;
  5. the stage-1 train step at full width (batch 16, TRAIN batches, the
     fitted stage-1 weights): record every kernel call of one step, forward
     and backward, and hold the ball query (kernel 6) and the 3-NN search
     (kernel 7, on the chunk bounds its forward's pre-pass wrote) against
     their plain versions on the recorded inputs (indices exact, d2
     bit-exact; kernel 6's bound counts the points of each query's z slab,
     with the index-order scan's bound beside it; kernel 7's the pairs of
     each query's z window, with the dense bound beside it), print the
     time of each by launch and on SA0's / FP0's inputs shuffled (exact
     against the plain version), and hold the interpolation's backward
     against autograd through its plain forward;
  6. the training path: one warm-up step through Trainer.train_steps, then
     timed steps closed by torch.cuda.synchronize() (steps/s, scenes/s,
     peak memory, the loss of each step); fps, three_interpolate,
     ball_query and three_nn must be launched, the BN running statistics
     must move; then one step under torch.profiler;
  7. one train step on 2 scenes on the GPU and on the CPU (the plain
     versions) from the same weights and batch, no dropout: loss and
     every gradient must agree;
  8. the stage-2 RCNN train step at full width (800 crops of 512 points,
     TRAIN batches of a synthetic proposal database, the fitted npz's
     stage-2 trunk): record every kernel call of one step, forward and
     backward, and hold FPS, both fused SA entries and the backward's ball
     query against their plain versions on the recorded inputs; run kernel
     9 (SA with given indices) on each backward's kernel-6 indices against
     its plain version and against the fused kernel's output for the same
     stage (bit-equal), then drive its entry point fused_sa_single_scale on
     them; hold the FusedSA backward against autograd through the plain
     forward;
  9. the RCNN training path: one warm-up step through Trainer.train_steps,
     then timed steps closed by torch.cuda.synchronize() (steps/s, crops/s,
     peak memory, finite losses); each step must launch FPS 3, the windowed
     fused SA 2, the full one 1 and the ball query 3 times; then one step
     under torch.profiler;
 10. the same for the IOUN cascade (CASCADE 1, trunk frozen; the cascade's
     weights from the seeded init, as the fitted cascade is dead on these
     crops): a step adds the trunk's forward launches, and the trunk must
     be bit-unchanged after the steps;
 11. one RCNN and one IOUN step on 8 crops on the GPU and on the CPU (the
     plain versions) from the same weights and batch: loss and every
     gradient must agree;
 12. kernels 10 (the z-window crop-gather) and 8 (the windowed 3-NN
     interpolation) on the inputs phase 2 recorded from the inference batch:
     kernel 10 at z_window 32, 1 and every tile against kernel 5 and its plain
     version (bit-equal; device time and slab bound as kernel 5's), kernel 8
     on the four FP calls against kernel 4 (bit-equal), kernel 7 (indices
     and d2 exact) and its plain version, and its CUDA-event and queued
     device times beside kernel 4's on the same inputs, in turns;
     then each through its entry point, with its launches counted:
     crop_gather(z_window=32, center_z=...) and the backbone's FP modules
     with sorted_points=True;
 13. the proposal-database path (tools/generate_box_dataset's device stage
     and host loop) at full width: 16 synthetic whole scenes of 16,384
     points, the fitted stage-1 weights, K = 64, max_crop 2048, score
     threshold 0.1; scenes/s of the device stage and of the whole loop,
     exactly one kernel-6w launch a scene, its recorded calls against its
     plain version (exact), its time by launch with its bound (the points
     of each centre's z slab, the dense bound beside it) and on the first
     scene's points shuffled (exact), one scene under torch.profiler;
 14. one scene of that path on the GPU and on the CPU (the plain versions):
     the same records, floats within 1e-5; then one RCNN train step at the
     stage-2 CLI's default batch of 64 crops from the generated database,
     with a finite loss;
 15. the auto-annotator (ws3d_tpu_torch.tools.eval_auto.run_eval) on 16
     scenes of the inference path (the EVAL loader, 16,384 points, K = 64,
     f32, the fitted npz) at batch 16, once to warm up and once timed:
     KITTI txt files into a temporary directory, the recall tally and the
     official AP; every inference kernel launched, at least one detection,
     the AP of the native library's path and of the NumPy path within 1e-6
     of each other, and the first scene's txt file equal to the same scene
     run on the CPU (the plain versions): every detection matched within
     1e-3 in centre and score unless its score lies within 0.02 of the
     threshold; prints the detections, the recall lines, the Car 3D AP and
     the seconds spent in inference, in the txt files and in the AP
     harness;
 16. print the kernel table, the card's name and power limit, and the
     result line.

Prints nothing of the result and exits 2 without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "ws3d_tpu", "data", "bench_weights.npz")
BATCH = 16
TIMED_ITERS = 3
TIMED_STEPS = 5

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 SIMT FLOP/s, dense
# TF32 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12

KERNELS = {
    "fps": ("ws3d_tpu_torch/csrc/fps.cu",
            "ws3d_tpu/ops/sampling.py:38"),
    "fused_sa_window": ("ws3d_tpu_torch/csrc/fused_sa.cu",
                        "ws3d_tpu/ops/fused_sa_window_pallas.py:44"),
    "fused_sa_full": ("ws3d_tpu_torch/csrc/fused_sa.cu",
                      "ws3d_tpu/ops/fused_sa_bq_pallas.py:54"),
    "three_interpolate": ("ws3d_tpu_torch/csrc/interpolate.cu",
                          "ws3d_tpu/ops/three_nn_pallas.py:49"),
    "crop_gather": ("ws3d_tpu_torch/csrc/crop_gather.cu",
                    "ws3d_tpu/ops/ball_query_pallas.py:113"),
    "ball_query": ("ws3d_tpu_torch/csrc/ball_query.cu",
                   "ws3d_tpu/ops/ball_query_pallas.py:34"),
    "three_nn": ("ws3d_tpu_torch/csrc/three_nn.cu",
                 "ws3d_tpu/ops/three_nn_pallas.py:21"),
    "fused_sa_idx": ("ws3d_tpu_torch/csrc/fused_sa.cu",
                     "ws3d_tpu/ops/fused_sa_pallas.py:28"),
    "ball_query_wrap": ("ws3d_tpu_torch/csrc/ball_query.cu",
                        "ws3d_tpu/ops/ball_query_pallas.py:34"),
    "three_interpolate_window": ("ws3d_tpu_torch/csrc/interpolate.cu",
                                 "ws3d_tpu/ops/three_nn_pallas.py:105"),
    "crop_gather_window": ("ws3d_tpu_torch/csrc/crop_gather.cu",
                           "ws3d_tpu/ops/ball_query_pallas.py:113"),
}
INFERENCE_KERNELS = ("fps", "fused_sa_window", "fused_sa_full",
                     "three_interpolate", "crop_gather")
TRAIN_KERNELS = ("fps", "three_interpolate", "ball_query", "three_nn")
STAGE2_BATCH = 800          # crops of a step (tools/bench_train.py)
STAGE2_POINTS = 512
# kernel launches of one stage-2 step: the SA stack's forward (FPS per
# sampled stage; SA0/SA1 windowed, SA2 full) and one ball query per fused
# stage in the backward; an IOUN step also runs the frozen trunk's forward
STAGE2_STEP_LAUNCHES = {
    "rcnn": {"fps": 3, "fused_sa_window": 2, "fused_sa_full": 1,
             "ball_query": 3},
    "ioun": {"fps": 6, "fused_sa_window": 4, "fused_sa_full": 2,
             "ball_query": 3}}
# the proposal-database path (tools/generate_box_dataset.py's defaults)
DB_SCENES = 16
DB_SCORE_THRESH = 0.1
DB_MAX_PROPOSALS = 64
DB_MAX_CROP = 2048
DB_KERNELS = ("fps", "fused_sa_window", "fused_sa_full", "three_interpolate",
              "ball_query_wrap")
CASCADE_CLI_BATCH = 64      # tools/train_cascade.py's default --batch
EVAL_SCENES = 16            # the auto-annotator's scenes (phase 15)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Device time of `fn`, ms a call: the launches queue behind a sleep
    kernel of about a millisecond issued before the start event, so the
    host's time in the wrappers does not show between them (cuda_ms reads
    it where a launch is shorter than its wrapper)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------- recording
class Recorder:
    """Wraps each kernel wrapper to keep a copy of the inputs (`calls`) of
    every call the pipeline makes (phases 2, 5 and 8 replay them) and, with
    `outputs`, of its outputs (`outputs`)."""

    def __init__(self, outputs: bool = False, only=None):
        from ws3d_tpu_torch.ops import (ball_query, crop_gather, fused_sa,
                                        fused_sa_idx, interpolate, sampling)
        self.calls, self.outputs, self.keep_outputs = [], [], outputs
        self.targets = [(sampling, "fps_cuda"), (fused_sa, "fused_sa_cuda"),
                        (interpolate, "three_interpolate_cuda"),
                        (crop_gather, "crop_gather_cuda"),
                        (ball_query, "ball_query_multi_cuda"),
                        (interpolate, "three_nn_cuda"),
                        (fused_sa_idx, "fused_sa_idx_cuda"),
                        (ball_query, "ball_query_wrap_cuda"),
                        (interpolate, "three_interpolate_window_cuda")]
        if only is not None:
            self.targets = [t for t in self.targets if t[1] in only]
        self.saved = {}

    def __enter__(self):
        import torch

        def keep(a):
            if isinstance(a, torch.Tensor):
                return a.detach().clone()
            if isinstance(a, (list, tuple)):
                return [keep(x) for x in a]
            return a
        for mod, name in self.targets:
            orig = getattr(mod, name)
            self.saved[(mod, name)] = orig

            def wrapped(*args, _orig=orig, _name=name, **kw):
                self.calls.append((_name, [keep(a) for a in args],
                                   dict(kw)))
                out = _orig(*args, **kw)
                if self.keep_outputs:
                    self.outputs.append(keep(out))
                return out
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for (mod, name), orig in self.saved.items():
            setattr(mod, name, orig)
        return False


# ------------------------------------------------------------ comparisons
def compare_call(name, args, kw):
    """-> (kernel key, max_abs_err, ms, plain_ms, bytes, ops, shape note)."""
    import torch
    from ws3d_tpu_torch.ops import (ball_query, crop_gather, fused_sa,
                                    fused_sa_idx, interpolate, sampling)

    if name == "fps_cuda":
        xyz, npoint = args
        idx, coords = sampling.fps_cuda(xyz, npoint)
        ref = sampling.fps_plain(xyz, npoint)
        if not torch.equal(idx, ref):
            bad = (idx != ref).sum().item()
            raise AssertionError(f"fps {tuple(xyz.shape)}->{npoint}: {bad} "
                                 f"indices differ from the plain version")
        ref_c = sampling.gather_points(xyz, ref.long())
        err = (coords - ref_c).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"fps coords differ by {err}")
        ms = cuda_ms(lambda: sampling.fps_cuda(xyz, npoint), 5)
        plain = cuda_ms(lambda: sampling.fps_plain(xyz, npoint), 1)
        R, N, _ = xyz.shape
        nbytes = R * N * 12 + R * npoint * 16
        ops = R * (npoint - 1) * N * 10
        return ("fps", err, ms, plain, nbytes, ops,
                f"R{R} N{N}->{npoint}")

    if name == "fused_sa_cuda":
        xyz, feat, new_xyz, radius, nsample, kernels, biases, window = args
        out = fused_sa.fused_sa_cuda(*args, **kw)
        ref = fused_sa.fused_sa_plain(xyz, feat, new_xyz, radius, nsample,
                                      kernels, biases)
        err = (out - ref).abs().max().item()
        # f32 sums over <= 515 terms in another order than the plain matmul
        tol = 1e-3 + 1e-4 * ref.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"fused_sa window={window} "
                                 f"{tuple(xyz.shape)}: max|diff| {err} > {tol}")
        key = "fused_sa_window" if window else "fused_sa_full"
        ms = cuda_ms(lambda: fused_sa.fused_sa_cuda(*args, **kw), 5)
        plain = cuda_ms(lambda: fused_sa.fused_sa_plain(
            xyz, feat, new_xyz, radius, nsample, kernels, biases), 1)
        B, P, C = feat.shape
        M = new_xyz.shape[1]
        widths = [C + 3] + [int(k.shape[1]) for k in kernels]
        mlp_ops = 2 * B * M * nsample * sum(
            a * b for a, b in zip(widths[:-1], widths[1:]))
        scanned = _scanned_points(xyz, new_xyz, radius, nsample)
        nbytes = 4 * (B * P * 3 + B * P * C + B * M * 3 + B * M * widths[-1]
                      + sum(k.numel() + b.numel()
                            for k, b in zip(kernels, biases)))
        # the MLP in three TF32 passes on the tensor cores, the search on
        # the SIMT cores; the larger of the two bounds
        ops = [(3 * mlp_ops, PEAK_TF32, "3xTF32 ops"),
               (9 * scanned, PEAK_F32, "search ops")]
        return (key, err, ms, plain, nbytes, ops,
                f"B{B} P{P} M{M} C{C} S{nsample} {widths} "
                + _plan_note(feat, new_xyz, nsample, widths))

    if name == "three_interpolate_cuda":
        # the forward's workspace, if it passed one, is left out: a call
        # here allocates its own, as the forward does
        args = args[:3]
        unknown, known, feats = args
        out = interpolate.three_interpolate_cuda(*args)
        ref = interpolate.three_interpolate_plain(*args)
        err = (out - ref).abs().max().item()
        tol = 1e-4 + 1e-5 * ref.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"three_interpolate {tuple(unknown.shape)}: "
                                 f"max|diff| {err} > {tol}")
        ms = cuda_ms(lambda: interpolate.three_interpolate_cuda(*args), 5)
        plain = cuda_ms(lambda: interpolate.three_interpolate_plain(*args), 1)
        B, n, _ = unknown.shape
        m, C = feats.shape[1], feats.shape[2]
        nbytes = 4 * (B * n * 3 + B * m * 3 + B * m * C + B * n * C)
        # the pairs these inputs need tested (~10 operations each): on
        # z-sorted clouds those inside each query's z window (kernel 8's
        # search), else every pair; then the weighted three-row sum
        dense = B * n * m * 10 + B * n * C * 5
        if _z_sorted(unknown) and _z_sorted(known):
            ops = (10 * int(interpolate.window_search(unknown, known)[2].sum())
                   + B * n * C * 5)
        else:
            ops = dense
        return ("three_interpolate", err, ms, plain, nbytes, ops,
                f"B{B} n{n} m{m} C{C} (dense bound "
                f"{_bound_ms(nbytes, dense):.4f} ms)")

    if name == "crop_gather_cuda":
        xyz, ch, centers, radius, k, grouped, z_window = args
        cargs = (xyz, ch, centers, radius, k, grouped)
        vals, cnt = crop_gather.crop_gather_cuda(*cargs, z_window)
        if z_window is None:
            def plain_fn():
                return crop_gather.crop_gather_plain(*cargs)
        else:
            def plain_fn():
                return crop_gather.crop_gather_window_plain(*cargs, z_window)
        rv, rc = plain_fn()
        if not torch.equal(cnt, rc):
            raise AssertionError(f"crop_gather z_window={z_window} counts "
                                 f"differ")
        err = (vals - rv).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"crop_gather z_window={z_window} values "
                                 f"differ by {err}")
        ms = cuda_ms(lambda: crop_gather.crop_gather_cuda(*cargs, z_window),
                     5)
        dev = device_ms(lambda: crop_gather.crop_gather_cuda(*cargs,
                                                             z_window), 5)
        plain = cuda_ms(plain_fn, 1)
        B, N, _ = xyz.shape
        Cc, M = ch.shape[1], centers.shape[1]
        lo = hi = None
        scanned = B * M * N
        if z_window is not None:
            lo, hi, fits = _crop_windows(xyz, centers, radius, z_window)
            lo, hi = torch.where(fits, lo, 0), torch.where(fits, hi, N)
            scanned = int((hi - lo).sum())
        # every point's xyz, the channels of the points some crop gathers
        # (each read once), the output and the counts
        gathered = _gathered_points(xyz, centers, radius, k, lo, hi)
        nbytes = 4 * (B * N * 3 + Cc * gathered + B * M * 2 + Cc * B * M * k
                      + B * M)
        # the points each centre must test, 6 operations each (2 sub, 2 mul,
        # 1 add, 1 compare): those of its z slab (z term below r2; kernel
        # 10: inside its range); every point (of its range) for the dense
        # bound
        slab = _slab_points(xyz, centers[..., 1], radius, lo, hi)
        ops = 6 * slab
        return ("crop_gather" if z_window is None else "crop_gather_window",
                err, ms, plain, nbytes, ops,
                f"B{B} N{N} M{M} k{k} W{z_window} (device {dev:.4f} ms "
                f"queued; dense bound {_bound_ms(nbytes, 6 * scanned):.4f} "
                f"ms; {slab / (B * M):.1f} slab points a centre; "
                f"{float(cnt.float().mean()):.1f} members a centre; "
                f"{gathered / B:.1f} of {N} points gathered a scene)")

    if name == "ball_query_wrap_cuda":
        radii, nsamples, xyz, new_xyz = args
        idx, cnt = ball_query.ball_query_wrap_cuda(*args)
        ridx, rcnt = ball_query.ball_query_wrap_plain(*args)
        for a, b in zip(idx + cnt, ridx + rcnt):
            if not torch.equal(a, b):
                bad = (a != b).sum().item()
                raise AssertionError(f"ball_query_wrap {tuple(xyz.shape)} "
                                     f"S{nsamples}: {bad} entries differ "
                                     f"from the plain version")
        ms = cuda_ms(lambda: ball_query.ball_query_wrap_cuda(*args), 5)
        dev = device_ms(lambda: ball_query.ball_query_wrap_cuda(*args), 5)
        plain = cuda_ms(lambda: ball_query.ball_query_wrap_plain(*args), 1)
        B, N, _ = xyz.shape
        M = new_xyz.shape[1]
        nbytes = 4 * (B * N * 3 + B * M * 3 + B * M * sum(nsamples)
                      + B * M * len(nsamples))
        # the points of each centre's z slab (z term below r2), each scale:
        # 3 sub, 3 mul, 2 add, 1 compare; every point for the dense bound
        slab = sum(_slab_points(xyz, new_xyz[..., 2], r) for r in radii)
        ops = 9 * slab
        dense = 9 * B * M * N * len(radii)
        return ("ball_query_wrap", 0.0, ms, plain, nbytes, ops,
                f"B{B} N{N} M{M} r{radii} S{nsamples} (device {dev:.4f} ms"
                f" queued; dense bound "
                f"{_bound_ms(nbytes, dense):.4f} ms; {slab / (B * M):.1f} "
                f"slab points a centre; {float(cnt[0].float().mean()):.1f} "
                f"members a centre)")

    if name == "three_interpolate_window_cuda":
        # the forward's workspace, if it passed one, is left out
        args = args[:3]
        unknown, known, feats = args
        out, d2, idx = interpolate.three_interpolate_window_cuda(
            *args, with_nn=True)
        rd2, ridx, visits = interpolate.window_search(unknown, known)
        kd2, kidx = interpolate.three_nn_cuda(unknown, known)      # kernel 7
        for what, (a, b) in (("the plain search", (idx, ridx.int())),
                             ("kernel 7", (idx, kidx))):
            if not torch.equal(a, b):
                bad = (a != b).sum().item()
                raise AssertionError(f"three_interpolate_window "
                                     f"{tuple(unknown.shape)}: {bad} indices "
                                     f"differ from {what}")
        if not (torch.equal(d2, rd2) and torch.equal(d2, kd2)):
            raise AssertionError("three_interpolate_window d2 differs")
        ref4 = interpolate.three_interpolate_cuda(*args)           # kernel 4
        err4 = (out - ref4).abs().max().item()
        # the same neighbours through the same arithmetic: bit-equal
        if not torch.equal(out, ref4):
            raise AssertionError(f"three_interpolate_window differs from "
                                 f"kernel 4 by {err4}")
        ref = interpolate.three_interpolate_window_plain(*args)
        err = (out - ref).abs().max().item()
        tol = 1e-4 + 1e-5 * ref.abs().max().item()
        if not err <= tol:
            raise AssertionError(f"three_interpolate_window "
                                 f"{tuple(unknown.shape)}: max|diff| {err} "
                                 f"> {tol}")
        ms = cuda_ms(lambda: interpolate.three_interpolate_window_cuda(*args),
                     5)
        plain = cuda_ms(
            lambda: interpolate.three_interpolate_window_plain(*args), 1)
        B, n, _ = unknown.shape
        m, C = feats.shape[1], feats.shape[2]
        nbytes = 4 * (B * n * 3 + B * m * 3 + B * m * C + B * n * C)
        # kernel 4's work (the timed calls write no neighbours): the pairs
        # inside each query's z window (~10 operations each) and the
        # weighted three-row sum
        ops = 10 * int(visits.sum()) + 5 * B * n * C
        return ("three_interpolate_window", err, ms, plain, nbytes, ops,
                f"B{B} n{n} m{m} C{C} ({float(visits.float().mean()):.1f} "
                f"window pairs a query)")

    if name == "ball_query_multi_cuda":
        radii, nsamples, xyz, new_xyz = args
        out = ball_query.ball_query_multi_cuda(*args)
        ref = ball_query.ball_query_multi_plain(*args)
        for o, r, k in zip(out, ref, nsamples):
            if not torch.equal(o, r):
                bad = (o != r).sum().item()
                raise AssertionError(f"ball_query {tuple(xyz.shape)} S{k}: "
                                     f"{bad} indices differ from the plain "
                                     f"version")
        ms = cuda_ms(lambda: ball_query.ball_query_multi_cuda(*args), 5)
        plain = cuda_ms(lambda: ball_query.ball_query_multi_plain(*args), 1)
        B, N, _ = xyz.shape
        M = new_xyz.shape[1]
        nbytes = 4 * (B * N * 3 + B * M * 3 + B * M * sum(nsamples))
        # the points each query must test: those of its z slab (z term
        # below its largest r2) up to the reach of an index-order scan
        tested, slab = _tested_points(radii, nsamples, xyz, new_xyz)
        ops = (8 + len(radii)) * slab
        return ("ball_query", 0.0, ms, plain, nbytes, ops,
                f"B{B} N{N} M{M} r{radii} S{nsamples} (index-order bound "
                f"{_bound_ms(nbytes, (8 + len(radii)) * tested):.4f} ms; "
                f"{slab / (B * M):.1f} of {tested / (B * M):.1f} points a "
                f"query in the slab)")

    if name == "three_nn_cuda":
        unknown, known = args[:2]
        d2, idx = interpolate.three_nn_cuda(*args)
        rd2, ridx = interpolate.three_nn_plain(unknown, known)
        if not torch.equal(idx, ridx):
            bad = (idx != ridx).sum().item()
            raise AssertionError(f"three_nn {tuple(unknown.shape)}: {bad} "
                                 f"indices differ from the plain version")
        err = (d2 - rd2).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"three_nn d2 differs by {err}")
        ms = cuda_ms(lambda: interpolate.three_nn_cuda(*args), 5)
        dev = device_ms(lambda: interpolate.three_nn_cuda(*args), 5)
        plain = cuda_ms(lambda: interpolate.three_nn_plain(unknown, known), 1)
        B, n, _ = unknown.shape
        m = known.shape[1]
        nbytes = 4 * (B * n * 3 + B * m * 3 + B * n * 6)
        # the pairs these inputs need tested (~10 operations each): on
        # z-sorted clouds those inside each query's z window (kernel 8's
        # search), else every pair
        dense = B * n * m * 10
        if _z_sorted(unknown) and _z_sorted(known):
            ops = 10 * int(interpolate.window_search(unknown, known)[2].sum())
        else:
            ops = dense
        return ("three_nn", err, ms, plain, nbytes, ops,
                f"B{B} n{n} m{m} (device {dev:.4f} ms queued; dense bound "
                f"{_bound_ms(nbytes, dense):.4f} ms"
                f"{'' if len(args) > 2 else '; with its pre-pass'})")

    if name == "fused_sa_idx_cuda":
        xyz, feat, new_xyz, idx, kernels, biases = args
        out = fused_sa_idx.fused_sa_idx_cuda(*args, **kw)
        ref = fused_sa_idx.fused_sa_idx_plain(idx, xyz, feat, new_xyz,
                                              kernels, biases)
        err = (out - ref).abs().max().item()
        # f32 sums in another order than the plain matmul
        tol = 1e-4 * ref.abs().max().item() + 1e-6
        if not err <= tol:
            raise AssertionError(f"fused_sa_idx {tuple(idx.shape)}: "
                                 f"max|diff| {err} > {tol}")
        ms = cuda_ms(lambda: fused_sa_idx.fused_sa_idx_cuda(*args, **kw), 5)
        plain = cuda_ms(lambda: fused_sa_idx.fused_sa_idx_plain(
            idx, xyz, feat, new_xyz, kernels, biases), 1)
        B, P, C = feat.shape
        M, S = idx.shape[1], idx.shape[2]
        widths = [C + 3] + [int(k.shape[1]) for k in kernels]
        nbytes = 4 * (B * P * 3 + B * P * C + B * M * 3 + B * M * S
                      + B * M * widths[-1]
                      + sum(k.numel() + b.numel()
                            for k, b in zip(kernels, biases)))
        # the MLP in three TF32 passes on the tensor cores
        ops = [(3 * 2 * B * M * S * sum(a * b for a, b in zip(widths[:-1],
                                                              widths[1:])),
                PEAK_TF32, "3xTF32 ops")]
        return ("fused_sa_idx", err, ms, plain, nbytes, ops,
                f"B{B} P{P} M{M} C{C} S{S} {widths} "
                + _plan_note(feat, new_xyz, S, widths))
    raise KeyError(name)


def _plan_note(feat, new_xyz, nsample, widths) -> str:
    """The launch layout csrc/fused_sa.cu plans for a fused SA call."""
    from ws3d_tpu_torch.ops import fused_sa
    p = fused_sa.fused_sa_plan(feat, new_xyz, nsample, widths)
    return (f"[{p['gather']} Q{p['Q']} Sp{p['Sp']} KC{p['KC']} "
            f"{p['warps']}w {p['smem'] / 1024:.1f}KB {p['blocks']} blocks]")


def _crop_windows(xyz, centers, radius, z_window):
    """Kernel 10's candidate range [lo, hi) of each centre and whether it
    fits `z_window` tiles."""
    from ws3d_tpu_torch.ops import crop_gather
    from ws3d_tpu_torch.ops.grouping import radius_sq
    lo, hi = crop_gather.z_windows(xyz[..., 2], centers[..., 1],
                                   radius_sq(radius, xyz.device))
    return lo, hi, crop_gather.window_tiles(lo, hi) <= z_window


def _bound_ms(nbytes, ops) -> float:
    """The f32 SIMT roofline bound of a call, ms."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_F32) * 1e3


def _z_sorted(pts) -> bool:
    z = pts[..., 2]
    return bool((z[:, 1:] >= z[:, :-1]).all())


def _slab_points(xyz, qz, radius, lo=None, hi=None) -> int:
    """Points of each query's z slab, z term fl(fl(qz - z)^2) below r2,
    inside its range [lo, hi) where given, summed over the queries (qz
    (B, M))."""
    import torch
    from ws3d_tpu_torch.ops.grouping import radius_sq
    r2 = radius_sq(radius, xyz.device)
    pos = torch.arange(xyz.shape[1], device=xyz.device)
    total = 0
    for m0 in range(0, qz.shape[1], 256):
        dz = qz[:, m0:m0 + 256, None] - xyz[:, None, :, 2]
        near = dz * dz < r2
        if lo is not None:
            near &= ((pos >= lo[:, m0:m0 + 256, None])
                     & (pos < hi[:, m0:m0 + 256, None]))
        total += int(near.sum())
    return total


def _gathered_points(xyz, centers, radius, k, lo=None, hi=None) -> int:
    """Points whose channels a crop gathers, summed over the scenes: the
    union of each scene's centres' first min(cnt, k) members (BEV d2 below
    r2, inside the range [lo, hi) where given)."""
    import torch
    from ws3d_tpu_torch.ops import crop_gather
    from ws3d_tpu_torch.ops.grouping import radius_sq
    r2 = radius_sq(radius, xyz.device)
    pos = torch.arange(xyz.shape[1], device=xyz.device)
    taken = torch.zeros(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    for m0 in range(0, centers.shape[1], 256):
        member = crop_gather._bev_member(xyz, centers[:, m0:m0 + 256], r2)
        if lo is not None:
            member &= ((pos >= lo[:, m0:m0 + 256, None])
                       & (pos < hi[:, m0:m0 + 256, None]))
        taken |= (member & (member.cumsum(-1) <= k)).any(1)
    return int(taken.sum())


def _tested_points(radii, nsamples, xyz, new_xyz):
    """Points the multi-scale ball query must test: (an index-order scan's,
    per query up to and including the S_i-th hit of the scale that fills
    last, all points when a scale does not fill; and of those, the points
    of the query's z slab: z term fl(fl(qz - z)^2) below its largest r2)."""
    import torch
    from ws3d_tpu_torch.ops.grouping import pairwise_sqdist, radius_sq
    N = xyz.shape[1]
    r2max = max(radius_sq(r, xyz.device) for r in radii)
    pos_n = torch.arange(N, device=xyz.device)
    total = slab = 0
    for m0 in range(0, new_xyz.shape[1], 256):
        q = new_xyz[:, m0:m0 + 256]
        d2 = pairwise_sqdist(q, xyz)                            # (B, m, N)
        reach = None
        for r, k in zip(radii, nsamples):
            cum = torch.cumsum(d2 < radius_sq(r, xyz.device), dim=-1)
            pos = torch.searchsorted(cum, torch.full_like(
                cum[..., :1], int(k)))[..., 0] + 1
            pos = torch.where(cum[..., -1] >= k, pos, N)
            reach = pos if reach is None else torch.maximum(reach, pos)
        total += int(reach.sum())
        dz = q[..., 2, None] - xyz[:, None, :, 2]
        slab += int(((dz * dz < r2max) & (pos_n < reach[..., None])).sum())
    return total, slab


def _scanned_points(xyz, new_xyz, radius, nsample) -> int:
    """Points the fused SA's search must test: per query, the points of its
    z slab (z term below r2) up to and including its S-th hit."""
    import torch
    from ws3d_tpu_torch.ops.grouping import pairwise_sqdist, radius_sq
    P = xyz.shape[1]
    r2 = radius_sq(radius, xyz.device)
    total = 0
    pos = torch.arange(P, device=xyz.device)
    for m0 in range(0, new_xyz.shape[1], 256):
        q = new_xyz[:, m0:m0 + 256]
        cum = torch.cumsum(pairwise_sqdist(q, xyz) < r2, dim=-1)
        reach = torch.where(cum[..., -1] >= nsample,
                            torch.searchsorted(cum, torch.full_like(
                                cum[..., :1], nsample))[..., 0] + 1, P)
        dz = q[..., 2, None] - xyz[:, None, :, 2]
        total += int(((pos < reach[..., None]) & (dz * dz < r2)).sum())
    return total


def _print_build(lib_path) -> None:
    """Each kernel's registers, shared memory and spills (ptxas -v), and
    from its SASS the tensor-core (HMMA) and cluster-barrier (UCGABAR)
    instructions; the fused SA routine must have TF32 HMMA in each of its
    three modes (kernels 3, 2 and 9) and no SIMT MLP routine may be left;
    the FPS cluster kernel must have UCGABAR."""
    import re
    import shutil

    def kernel_name(mangled):
        # <length><name> in the mangled symbol, then ILi<N>E for a template
        # (a hash before it may end in digits: try each tail of the run)
        for m in re.finditer(r"\d+", mangled):
            i = m.end()
            for k in range(m.start(), i):
                n = int(mangled[k:i])
                if mangled[i:i + n].endswith("_kernel"):
                    t = re.match(r"ILi(\d+)E", mangled[i + n:])
                    return mangled[i:i + n] + (f"<{t.group(1)}>" if t else "")
        return None
    name = None
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif name and ("registers" in line or "spill" in line):
            print(f"#   {name}: {line.strip().removeprefix('ptxas info    : ')}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        key = kernel_name(part.split("\n", 1)[0])
        ops = re.findall(r"\b(HMMA\.[\w.]+|UCGABAR_\w+)", part)
        counts[key] = {op: ops.count(op) for op in sorted(set(ops))}
        if ops:
            print(f"#   SASS {key}: {counts[key]}")
    if not any(k.startswith("fps_cluster_kernel") for k in counts):
        raise AssertionError("no FPS cluster kernel in the library")
    for mode in range(3):         # kFull (kernel 3), kWindow (2), kGiven (9)
        if not any(op.startswith("HMMA") and "TF32" in op
                   for op in counts.get(f"fused_sa_tc_kernel<{mode}>", {})):
            raise AssertionError(f"fused_sa_tc_kernel<{mode}> has no TF32 "
                                 f"HMMA instruction")
    if any(k.startswith("fused_sa_kernel") for k in counts):
        raise AssertionError("the SIMT MLP routine fused_sa_kernel is in the "
                             "library")
    if not all(any(op.startswith("UCGABAR") for op in ops)
               for k, ops in counts.items()
               if k.startswith("fps_cluster_kernel")):
        raise AssertionError("the FPS cluster kernel has no cluster barrier")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "ws3d_tpu_torch")) or \
            not os.path.exists(WEIGHTS):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    from ws3d_tpu_torch.weights import load_npz

    # f32 throughout, as the plain versions and the JAX reference compute:
    # no TF32 in the dense layers, nor in any cuDNN op a later slice adds
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"# card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 1. build
    t0 = time.perf_counter()
    lib_path = _kernels.build()
    _kernels.library()
    print(f"# phase 1: built {lib_path} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    _print_build(lib_path)

    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    model = build_model(cfg)                       # CUDA
    load_npz(model, WEIGHTS)
    fn = make_two_stage_fn(model, cfg)

    n_scenes = BATCH * 2
    src = SyntheticKitti(num_scenes=n_scenes, points_per_scene=20000, seed=3)
    ds = RPNDataset(src, cfg, mode="EVAL", npoints=cfg.RPN.NUM_POINTS,
                    seed=0)
    bufs = [torch.from_numpy(b["pts_input"]).cuda()
            for b in ds.batches(batch_size=BATCH, steps=2)]

    # ---- 2. each kernel against its plain version at main-path shapes
    t0 = time.perf_counter()
    with Recorder() as rec:
        fn(bufs[0])
        torch.cuda.synchronize()
    per_kernel = {k: _fresh() for k in KERNELS}
    rows = _compare_calls(rec.calls, per_kernel, "inference")
    for num, key in ((2, "fused_sa_window"), (3, "fused_sa_full"),
                     (4, "three_interpolate")):
        kr = [r for r in rows if r[0] == key]
        print(f"# phase 2: kernel {num} by launch ({len(kr)} a batch): "
              + "; ".join(f"{note} {ms:.4f} ms (bound {b:.4f})"
                          for _, note, ms, b in kr), flush=True)
    k1 = [r for r in rows if r[0] == "fps"]
    print(f"# phase 2: FPS by row class ({len(k1)} a batch): "
          + "; ".join(f"{note} {ms:.4f} ms" for _, note, ms, _ in k1)
          + f"; the database's row (one scene) {_fps_one_row(rec.calls)}",
          flush=True)
    # the crop and FP inputs kernels 10 and 8 run on in phase 12
    crop_call = [a for n, a, _ in rec.calls if n == "crop_gather_cuda"][0]
    fp_calls = [a[:3] for n, a, _ in rec.calls
                if n == "three_interpolate_cuda"]
    print(f"# phase 2: kernel 4 on FP0's inputs shuffled: "
          f"{_shuffled('three_interpolate_cuda', fp_calls)}", flush=True)
    print(f"# phase 2: kernel 5 on the first scene's points shuffled: "
          f"{_shuffled('crop_gather_cuda', [crop_call])}", flush=True)
    for key in INFERENCE_KERNELS:
        if per_kernel[key]["ms"] == 0.0:
            raise AssertionError(f"kernel {key} was never called on the "
                                 f"inference path")
    print(f"# phase 2: {len(rec.calls)} kernel calls compared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. the inference path
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(bufs[0])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    times, outs = [], []
    for it in range(TIMED_ITERS):
        t0 = time.perf_counter()
        out = fn(bufs[(it + 1) % len(bufs)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = {"inference": dict(_kernels.LAUNCHES)}
    missing = [k for k in INFERENCE_KERNELS if launches["inference"][k] == 0]
    if missing:
        raise AssertionError(f"inference path launched no {missing}")
    packed = outs[-1]["packed"]
    keep = outs[-1]["keep"]
    # boxes are finite everywhere; a score is -inf where the cascade did
    # not run (such slots are never kept)
    if not (bool(torch.isfinite(packed[..., 0:7]).all())
            and bool(torch.isfinite(packed[..., 7][keep]).all())):
        raise AssertionError("non-finite values in the packed record")
    if tuple(packed.shape) != (BATCH, cfg.TPU.MAX_PROPOSALS, 9):
        raise AssertionError(f"packed shape {tuple(packed.shape)}")
    n_det = int(outs[-1]["keep"].sum())
    n_live = int(outs[-1]["n_live"])
    spilled = max(int(o["spilled"]) for o in outs)
    sps = BATCH * TIMED_ITERS / sum(times)
    print(f"# phase 3: {card}: {sps:.2f} scenes/s "
          f"(batch {BATCH}, {TIMED_ITERS} timed batches "
          f"{[round(t * 1e3, 1) for t in times]} ms, warm-up "
          f"{warm * 1e3:.1f} ms); detections {n_det}, n_live {n_live}, "
          f"max spilled {spilled}; launches {launches['inference']}",
          flush=True)

    _profile(lambda: fn(bufs[1]), 1e3 * sum(times) / len(times),
             "phase 3 profile", "batch")

    # ---- 4. one scene: GPU port vs CPU plain versions
    t0 = time.perf_counter()
    scene = bufs[0][:1].contiguous()
    gpu = {k: v.cpu() for k, v in fn(scene).items()}
    cpu_model = build_model(cfg, device="cpu")
    load_npz(cpu_model, WEIGHTS)
    cpu = make_two_stage_fn(cpu_model, cfg)(scene.cpu())
    _check_detections(gpu, cpu, float(cfg.IOUN.SCORE_THRESH))
    print(f"# phase 4: one scene GPU vs CPU plain: {int(gpu['keep'].sum())} "
          f"vs {int(cpu['keep'].sum())} detections agree "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del fn, cpu_model, rec

    # ---- 5.-7. the stage-1 training path
    launches["train"] = _train_phases(card, per_kernel)

    # ---- 8.-11. the stage-2 (RCNN, IOUN) training paths
    launches.update(_stage2_phases(card, per_kernel))

    # ---- 12. kernels 10 and 8 on the inference batch's inputs
    launches.update(_window_phases(model, bufs[0], crop_call, fp_calls,
                                   per_kernel))
    del model, bufs, crop_call, fp_calls
    torch.cuda.empty_cache()

    # ---- 13.-14. the proposal-database path
    launches["proposal_db"] = _db_phases(card, per_kernel)

    # ---- 15. the auto-annotator
    launches["eval_auto"] = _eval_phase(card)

    # ---- 16. report
    table = []
    for key, (source, replaces) in KERNELS.items():
        agg = per_kernel[key]
        by_path = {p: v[key] for p, v in launches.items() if v[key]}
        table.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": agg["err"], "ms": agg["ms"],
            "plain_ms": agg["plain"], "bound_ms": agg["bound"],
            "bound_by": ("bytes" if agg["by_bytes"] >= agg["bound"] / 2
                         else "operations"),
            "library_ms": None, "ms_by_path": agg["ms_by_path"]})
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _compare_calls(calls, per_kernel, path: str) -> list:
    """Replay recorded kernel calls of `path` against their plain versions
    and add each call's error, times and bound to `per_kernel`; returns
    (kernel, shape note, ms, bound ms) of each call."""
    import torch
    rows = []
    with torch.no_grad():
        for name, args, kw in calls:
            key, err, ms, plain, nbytes, ops, note = compare_call(name, args,
                                                                  kw)
            if not isinstance(ops, list):
                ops = [(ops, PEAK_F32, "operations")]
            t_ops, label = max((n_ops / peak * 1e3, what)
                               for n_ops, peak, what in ops)
            t_bytes = nbytes / PEAK_BYTES * 1e3
            agg = per_kernel[key]
            agg["err"] = max(agg["err"], err)
            agg["ms"] += ms
            agg["ms_by_path"][path] = agg["ms_by_path"].get(path, 0.0) + ms
            agg["plain"] += plain
            agg["bound"] += max(t_bytes, t_ops)
            agg["by_bytes"] += t_bytes if t_bytes >= t_ops else 0.0
            rows.append((key, note, ms, max(t_bytes, t_ops)))
            print(f"#   {key:17s} {note:44s} err {err:.3g} kernel {ms:.4f} ms"
                  f" plain {plain:.3f} ms bound {max(t_bytes, t_ops):.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else label})", flush=True)
    return rows


def _shuffled(name, calls) -> str:
    """Kernel 6, 4, 7 or 6w on the largest of its recorded calls, or kernel
    5 on its first scene, with each cloud's points in a random order (the
    known points with their feature rows, the crop's points with their
    channels; kernel 6w's and the crop's centres keep theirs), where no
    chunk can be skipped: held against its plain version on the same
    shuffled inputs (indices, d2 and the crop exact; the interpolation
    within its gate); returns the shape and CUDA-event times of the kernel
    on the shuffled and on the recorded inputs (kernel 5: device times
    too)."""
    import torch
    from ws3d_tpu_torch.ops import ball_query, crop_gather, interpolate
    gen = torch.Generator(device="cuda").manual_seed(11)

    def shuffle(*ts):
        B, N = ts[0].shape[:2]
        perm = torch.argsort(torch.rand((B, N), device="cuda",
                                        generator=gen), dim=1)
        return [torch.gather(x, 1, perm[..., None].expand(-1, -1, x.shape[2]))
                .contiguous() for x in ts]

    def same(got, ref, what):
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            raise AssertionError(f"{what} on shuffled inputs differs from "
                                 f"the plain version")
    if name in ("ball_query_multi_cuda", "ball_query_wrap_cuda"):
        radii, ks, xyz, new_xyz = max(calls, key=lambda a: a[2].shape[1])
        sxyz, = shuffle(xyz)
        snew, = (shuffle(new_xyz) if name == "ball_query_multi_cuda"
                 else (new_xyz,))
        if name == "ball_query_multi_cuda":
            run = ball_query.ball_query_multi_cuda
            same(run(radii, ks, sxyz, snew),
                 ball_query.ball_query_multi_plain(radii, ks, sxyz, snew),
                 "ball_query")
        else:
            run = ball_query.ball_query_wrap_cuda
            got, ref = (f(radii, ks, sxyz, snew) for f in (
                run, ball_query.ball_query_wrap_plain))
            same(got[0] + got[1], ref[0] + ref[1], "ball_query_wrap")
        shape = f"B{xyz.shape[0]} N{xyz.shape[1]} M{new_xyz.shape[1]}"
        ms = cuda_ms(lambda: run(radii, ks, sxyz, snew), 5)
        ms0 = cuda_ms(lambda: run(radii, ks, xyz, new_xyz), 5)
    elif name == "crop_gather_cuda":
        xyz, ch, centers, radius, k, grouped = calls[0][:6]
        xyz, ch, centers = xyz[:1], ch[:1], centers[:1].contiguous()
        perm = torch.randperm(xyz.shape[1], device="cuda", generator=gen)
        sxyz = xyz[:, perm].contiguous()
        sch = ch[:, :, perm].contiguous()
        xyz, ch = xyz.contiguous(), ch.contiguous()
        run = crop_gather.crop_gather_cuda
        same(run(sxyz, sch, centers, radius, k, grouped),
             crop_gather.crop_gather_plain(sxyz, sch, centers, radius, k,
                                           grouped), "crop_gather")
        shape = f"B1 N{xyz.shape[1]} M{centers.shape[1]} k{k}"
        ms = cuda_ms(lambda: run(sxyz, sch, centers, radius, k, grouped), 5)
        ms0 = cuda_ms(lambda: run(xyz, ch, centers, radius, k, grouped), 5)
        dev = device_ms(lambda: run(sxyz, sch, centers, radius, k, grouped),
                        5)
        dev0 = device_ms(lambda: run(xyz, ch, centers, radius, k, grouped),
                         5)
        return (f"{shape}: {ms:.4f} ms shuffled, {ms0:.4f} ms as recorded "
                f"(device {dev:.4f} / {dev0:.4f} ms queued; the plain "
                f"version agrees)")
    elif name == "three_nn_cuda":
        unknown, known = max(calls, key=lambda a: a[0].shape[1])[:2]
        su, = shuffle(unknown)
        sk, = shuffle(known)
        same(interpolate.three_nn_cuda(su, sk),
             interpolate.three_nn_plain(su, sk), "three_nn")
        shape = f"B{unknown.shape[0]} n{unknown.shape[1]} m{known.shape[1]}"
        ms = cuda_ms(lambda: interpolate.three_nn_cuda(su, sk), 5)
        ms0 = cuda_ms(lambda: interpolate.three_nn_cuda(unknown, known), 5)
    else:
        unknown, known, feats = max(calls, key=lambda a: a[0].shape[1])
        su, = shuffle(unknown)
        sk, sf = shuffle(known, feats)
        got = interpolate.three_interpolate_cuda(su, sk, sf)
        ref = interpolate.three_interpolate_plain(su, sk, sf)
        err = (got - ref).abs().max().item()
        if not err <= 1e-4 + 1e-5 * ref.abs().max().item():
            raise AssertionError(f"three_interpolate on shuffled inputs "
                                 f"differs by {err}")
        shape = (f"B{unknown.shape[0]} n{unknown.shape[1]} m{known.shape[1]} "
                 f"C{feats.shape[2]}")
        ms = cuda_ms(lambda: interpolate.three_interpolate_cuda(su, sk, sf),
                     5)
        ms0 = cuda_ms(lambda: interpolate.three_interpolate_cuda(
            unknown, known, feats), 5)
    return (f"{shape}: {ms:.4f} ms shuffled, {ms0:.4f} ms as recorded "
            f"(the plain version agrees)")


def _fps_one_row(calls) -> str:
    """Kernel 1 on the first row of the batch's largest FPS input: the
    proposal-database path's row class (one scene of 16,384 points, C = 16
    CTAs a cluster where the batch gets 8). Indices must equal the plain
    version's; returns its shape and CUDA-event time."""
    import torch
    from ws3d_tpu_torch.ops import sampling
    xyz, npoint = max((a for n, a, _ in calls if n == "fps_cuda"),
                      key=lambda a: a[0].shape[1])
    one = xyz[:1].contiguous()
    idx, _ = sampling.fps_cuda(one, npoint)
    if not torch.equal(idx, sampling.fps_plain(one, npoint)):
        raise AssertionError("fps on one 16,384-point row differs from the "
                             "plain version")
    ms = cuda_ms(lambda: sampling.fps_cuda(one, npoint), 5)
    return f"R1 N{one.shape[1]}->{npoint} {ms:.4f} ms"


def _rpn_model(cfg, device):
    """The stage-1 model with the fitted npz's stage-1 entries."""
    import numpy as np
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.weights import load_flat
    model = build_model(cfg, device=device)
    with np.load(WEIGHTS) as z:
        load_flat(model, {k: z[k] for k in z.files
                          if k.split("/")[1] == "rpn"})
    return model


def _train_phases(card, per_kernel) -> dict:
    """Phases 5-7 on the stage-1 train step at batch 16; returns the
    training path's launch counts."""
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.ops.interpolate import (interpolate_features,
                                                three_interpolate_plain)
    from ws3d_tpu_torch.training import Trainer
    from ws3d_tpu_torch.training.trainer import batch_to_device, rpn_gradients

    t0 = time.perf_counter()
    cfg = load_config()                       # stage 1, DP_RATIO 0.5
    model = _rpn_model(cfg, "cuda")
    src = SyntheticKitti(num_scenes=BATCH * 2, points_per_scene=20000, seed=3)
    ds = RPNDataset(src, cfg, mode="TRAIN", seed=0)
    host = list(ds.batches(BATCH, steps=TIMED_STEPS + 2, shuffle=True))
    batches = [batch_to_device(b, "cuda") for b in host]
    trainer = Trainer(model, cfg, total_steps=1000, seed=0,
                      log_fn=lambda msg: print("#   " + msg, flush=True))
    print(f"# phase 5: {len(host)} TRAIN batches of {BATCH} made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 5. kernels 6 and 7 on the inputs of one step, and the backward
    t0 = time.perf_counter()
    with Recorder() as rec:
        rpn_gradients(model, cfg, batches[0], trainer.generator, 0.1,
                      trainer.optimizer.params)
        torch.cuda.synchronize()
    calls = [c for c in rec.calls
             if c[0] in ("ball_query_multi_cuda", "three_nn_cuda")]
    rows = _compare_calls(calls, per_kernel, "train")
    kr = [r for r in rows if r[0] == "ball_query"]
    print(f"# phase 5: kernel 6 by launch ({len(kr)} a step): "
          + "; ".join(f"{note.split(' (')[0]} {ms:.4f} ms (bound {b:.4f})"
                      for _, note, ms, b in kr), flush=True)
    print(f"# phase 5: kernel 6 on SA0's inputs shuffled: "
          + _shuffled("ball_query_multi_cuda",
                      [a for n, a, _ in calls if n == "ball_query_multi_cuda"]),
          flush=True)
    kr = [r for r in rows if r[0] == "three_nn"]
    print(f"# phase 5: kernel 7 by launch ({len(kr)} a step, on the "
          f"forward's chunk bounds): "
          + "; ".join(f"{note} {ms:.4f} ms (bound {b:.4f})"
                      for _, note, ms, b in kr), flush=True)
    print(f"# phase 5: kernel 7 on FP0's inputs shuffled (with its "
          f"pre-pass): "
          + _shuffled("three_nn_cuda",
                      [a for n, a, _ in calls if n == "three_nn_cuda"]),
          flush=True)
    for key in ("ball_query", "three_nn"):
        if per_kernel[key]["ms"] == 0.0:
            raise AssertionError(f"kernel {key} was never called in a step")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, args, _ in rec.calls:
        if name != "three_interpolate_cuda":
            continue
        unknown, known, feats = args[:3]
        g = torch.randn(unknown.shape[:2] + feats.shape[2:], device="cuda",
                        generator=gen)
        f1 = feats.clone().requires_grad_(True)
        f2 = feats.clone().requires_grad_(True)
        (interpolate_features(unknown, known, f1) * g).sum().backward()
        (three_interpolate_plain(unknown, known, f2) * g).sum().backward()
        err = (f1.grad - f2.grad).abs().max().item()
        # the same weighted sums, added by atomics in another order
        tol = 1e-5 * f2.grad.abs().max().item() + 1e-6
        print(f"#   interpolate backward n{unknown.shape[1]} "
              f"m{known.shape[1]} C{feats.shape[2]}: max|diff| {err:.3g} "
              f"(tol {tol:.3g})", flush=True)
        if not err <= tol:
            raise AssertionError(f"interpolation backward differs by {err}")
    print(f"# phase 5: {len(calls)} kernel calls of one train step compared "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 6. the training path
    bn = model.rpn.backbone.sa_0.mlp_0.BatchNorm_0
    stats = (bn.mean.clone(), bn.var.clone())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train_steps([host[0]], total_steps=1, log_every=1,
                        prefetch_size=0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    times, step_losses = [], []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        aux = trainer.step_fn(batches[1 + i], trainer.generator,
                              trainer.bn_sched(0))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_losses.append(aux["loss"])
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_losses = [float(v) for v in step_losses]
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"training path launched no {missing}")
    if not all(math.isfinite(v) for v in step_losses):
        raise AssertionError(f"non-finite loss {step_losses}")
    if torch.equal(stats[0], bn.mean) or torch.equal(stats[1], bn.var):
        raise AssertionError("the BN running statistics did not move")
    if trainer.step != 1 + TIMED_STEPS:
        raise AssertionError(f"optimizer count {trainer.step}")
    step_ms = 1e3 * sum(times) / len(times)
    print(f"# phase 6: {card}: {1e3 / step_ms:.3f} steps/s, "
          f"{BATCH * 1e3 / step_ms:.2f} scenes/s (batch {BATCH}, "
          f"{TIMED_STEPS} timed steps {[round(t * 1e3, 1) for t in times]} "
          f"ms, warm-up {warm * 1e3:.1f} ms); peak memory "
          f"{peak / 2**30:.2f} GiB; losses "
          f"{[round(v, 5) for v in step_losses]}; launches {launches}",
          flush=True)
    _profile(lambda: trainer.step_fn(batches[-1], trainer.generator,
                                     trainer.bn_sched(0)),
             step_ms, "phase 6 profile", "step")

    # ---- 7. one train step on 2 scenes: GPU vs CPU plain versions
    t0 = time.perf_counter()
    cfg.RPN.DP_RATIO = 0.0
    two = {k: v[:2] for k, v in host[0].items()}
    res = []
    for device in ("cuda", "cpu"):
        m = _rpn_model(cfg, device)
        loss, _, grads = rpn_gradients(
            m, cfg, batch_to_device(two, device), None, 0.1,
            dict(m.rpn.named_parameters(prefix="rpn")))
        res.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
    (gl, gg), (cl, cg) = res
    rel = abs(gl - cl) / abs(cl)
    if not rel <= 1e-3:
        raise AssertionError(f"train-step loss GPU {gl} vs CPU {cl}")
    worst = ("", 0.0)
    for k, g in gg.items():
        e = ((g - cg[k]).abs().max() / cg[k].abs().max()).item()
        if not e <= 1e-3:
            raise AssertionError(f"gradient {k}: GPU vs CPU {e:.3g} of its "
                                 f"largest magnitude")
        worst = max(worst, (k, e), key=lambda x: x[1])
    print(f"# phase 7: train step on 2 scenes GPU vs CPU plain: loss {gl:.6f} "
          f"vs {cl:.6f} (rel {rel:.3g}); worst gradient {worst[0]} "
          f"{worst[1]:.3g} of its largest magnitude "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return launches


def _stage2_cfg(stage: str):
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.tools.train_cascade import configure
    cfg = load_config()
    configure(cfg, stage, STAGE2_POINTS)
    return cfg


def _stage2_model(cfg, device):
    """The stage-2 model with the fitted npz's RCNN trunk; an IOUN model's
    cascade keeps its seeded init (the fitted cascade's ReLUs are all off
    below SA1's last layer on these crops, so it would train nothing)."""
    import numpy as np
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training.trainer import CASCADE_PREFIXES
    from ws3d_tpu_torch.weights import load_flat, to_flat
    model = build_model(cfg, device=device, seed=0)
    flat = to_flat(model)
    with np.load(WEIGHTS) as z:
        flat.update({k: z[k] for k in z.files if k in flat and not
                     k.split("/")[2].startswith(CASCADE_PREFIXES)})
    load_flat(model, flat)
    return model


def _stage2_batches(cfg, n: int):
    """`n` TRAIN batches of STAGE2_BATCH crops from a synthetic proposal
    database (host NumPy)."""
    from ws3d_tpu_torch.datasets import (BoxPlaceDataset,
                                         synthetic_proposal_database)
    db = synthetic_proposal_database(num=STAGE2_BATCH // 2, seed=0,
                                     crop_points=STAGE2_POINTS)
    ds = BoxPlaceDataset(db, cfg, mode="TRAIN", npoints=STAGE2_POINTS,
                         seed=0)
    return list(ds.batches(STAGE2_BATCH, steps=n))


def _stage2_phases(card, per_kernel) -> dict:
    """Phases 8-11; returns the launch counts of the RCNN and IOUN training
    paths and of kernel 9's entry point."""
    import torch
    t0 = time.perf_counter()
    host = {stage: _stage2_batches(_stage2_cfg(stage), TIMED_STEPS + 2)
            for stage in ("rcnn", "ioun")}
    print(f"# phase 8: {TIMED_STEPS + 2} TRAIN batches of {STAGE2_BATCH} "
          f"crops a stage made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches = {"sa_given_idx": _stage2_kernels(host["rcnn"][0], per_kernel)}
    torch.cuda.empty_cache()
    for phase, stage in ((9, "rcnn"), (10, "ioun")):
        launches[f"{stage}_train"] = _stage2_train(phase, stage, card,
                                                   host[stage])
        torch.cuda.empty_cache()
    _stage2_small({stage: b[0] for stage, b in host.items()})
    return launches


def _stage2_kernels(host_batch, per_kernel) -> dict:
    """Phase 8 on one RCNN step; returns the launch counts of kernel 9's
    entry point, driven on the step's own inputs and indices."""
    import torch
    from ws3d_tpu_torch.ops import _kernels, fused_sa_idx
    from ws3d_tpu_torch.ops.fused_sa import fused_sa_plain, fused_sa_train
    from ws3d_tpu_torch.training.trainer import (batch_to_device,
                                                 rcnn_gradients, step_inputs,
                                                 trainable_parameters)
    t0 = time.perf_counter()
    cfg = _stage2_cfg("rcnn")
    model = _stage2_model(cfg, "cuda")
    batch = batch_to_device(host_batch, "cuda",
                            step_inputs("rcnn", host_batch))
    with Recorder(outputs=True) as rec:
        rcnn_gradients(model, cfg, "rcnn", batch, None, 0.1,
                       trainable_parameters(model, "rcnn"))
        torch.cuda.synchronize()
    del model, batch
    names = [c[0] for c in rec.calls]
    counts = {k: names.count(k) for k in set(names)}
    if counts != {"fps_cuda": 3, "fused_sa_cuda": 3,
                  "ball_query_multi_cuda": 3}:
        raise AssertionError(f"one RCNN step made the kernel calls {counts}")
    _compare_calls(rec.calls, per_kernel, "rcnn_train")

    # kernel 9 on the indices kernel 6 gave each backward
    fused = [(a, o) for (n, a, _), o in zip(rec.calls, rec.outputs)
             if n == "fused_sa_cuda"]
    idx_calls = []
    for (n, a, _), o in zip(rec.calls, rec.outputs):
        if n != "ball_query_multi_cuda":
            continue
        (radius,), (nsample,), xyz, new_xyz = a
        idx = o[0]
        match = [(fa, fo) for fa, fo in fused
                 if (fa[3], fa[4]) == (radius, nsample)
                 and torch.equal(fa[0], xyz) and torch.equal(fa[2], new_xyz)]
        if len(match) != 1:
            raise AssertionError(f"{len(match)} fused SA calls match the "
                                 f"ball query r{radius} S{nsample}")
        (_, feat, _, _, _, kernels, biases, window), fo = match[0]
        got = fused_sa_idx.fused_sa_idx_cuda(xyz, feat, new_xyz, idx,
                                             kernels, biases)
        err = (got - fo).abs().max().item()
        print(f"#   fused_sa_idx on kernel 6's indices vs the fused kernel "
              f"(window={window}) S{nsample}: max|diff| {err:.3g}",
              flush=True)
        # the same rows through the same routine: bit-equal
        if not torch.equal(got, fo):
            raise AssertionError(f"kernel 9 differs from the fused kernel "
                                 f"by {err}")
        idx_calls.append(("fused_sa_idx_cuda",
                          [xyz, feat, new_xyz, idx, kernels, biases], {}))
    _compare_calls(idx_calls, per_kernel, "rcnn_train")

    # kernel 9's entry point, forward and backward, on the same inputs
    _kernels.reset_launch_counts()
    for _, (xyz, feat, new_xyz, idx, kernels, biases), _ in idx_calls:
        leaves = [x.clone().requires_grad_(True)
                  for x in (feat, *kernels, *biases)]
        L = len(kernels)
        out = fused_sa_idx.fused_sa_single_scale(
            xyz, leaves[0], new_xyz, idx, leaves[1:1 + L], leaves[1 + L:])
        grads = torch.autograd.grad(out.sum(), leaves)
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError("non-finite fused_sa_single_scale gradient")
    torch.cuda.synchronize()
    entry = dict(_kernels.LAUNCHES)
    if entry["fused_sa_idx"] != len(idx_calls):
        raise AssertionError(f"fused_sa_single_scale launched kernel 9 "
                             f"{entry['fused_sa_idx']} times")

    # the FusedSA backward against autograd through the plain forward
    gen = torch.Generator(device="cuda").manual_seed(7)
    for (xyz, feat, new_xyz, radius, nsample, kernels, biases, window), fo \
            in fused:
        g = torch.randn(fo.shape, device="cuda", generator=gen)
        grads = []
        for fn in (lambda *x: fused_sa_train(*x, window), fused_sa_plain):
            leaves = [x.clone().requires_grad_(True)
                      for x in (xyz, feat, new_xyz, *kernels, *biases)]
            L = len(kernels)
            out = fn(*leaves[:3], radius, nsample, leaves[3:3 + L],
                     leaves[3 + L:])
            grads.append(torch.autograd.grad((out * g).sum(), leaves))
            del out
        worst = 0.0
        for a, b in zip(*grads):
            scale = b.abs().max().item()
            e = (a - b).abs().max().item()
            # the same plain ops on the same indices; the gather's backward
            # adds with atomics in another order
            if not e <= 1e-5 * scale:
                raise AssertionError(f"FusedSA backward (window={window}) "
                                     f"differs by {e} of {scale}")
            worst = max(worst, e / scale if scale else 0.0)
        print(f"#   FusedSA backward window={window} S{nsample} vs autograd "
              f"through the plain forward: worst {worst:.3g} of a "
              f"gradient's largest magnitude", flush=True)
        del grads
    print(f"# phase 8: {len(rec.calls)} kernel calls of one RCNN step and "
          f"{len(idx_calls)} kernel-9 calls compared; fused_sa_single_scale "
          f"launches {entry['fused_sa_idx']} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return entry


def _stage2_train(phase: int, stage: str, card, host) -> dict:
    """Phase 9 (rcnn) or 10 (ioun): warm-up, timed and profiled steps at
    STAGE2_BATCH crops; returns the path's launch counts."""
    import torch
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.training import Trainer
    from ws3d_tpu_torch.training.trainer import batch_to_device, step_inputs
    cfg = _stage2_cfg(stage)
    model = _stage2_model(cfg, "cuda")
    batches = [batch_to_device(b, "cuda", step_inputs(stage, b))
               for b in host]
    trainer = Trainer(model, cfg, total_steps=1000, stage=stage, seed=0,
                      log_fn=lambda msg: print("#   " + msg, flush=True))
    frozen = {k: v.clone() for k, v in model.state_dict().items()
              if k not in trainer.optimizer.params}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train_steps([host[0]], total_steps=1, log_every=1,
                        prefetch_size=0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    times, step_losses = [], []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        aux = trainer.step_fn(batches[1 + i], trainer.generator,
                              trainer.bn_sched(0))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        step_losses.append(aux["loss"])
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    step_losses = [float(v) for v in step_losses]
    want = {k: v * (1 + TIMED_STEPS)
            for k, v in STAGE2_STEP_LAUNCHES[stage].items()}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        raise AssertionError(f"{stage} steps launched {got}, not {want}")
    if not all(math.isfinite(v) for v in step_losses):
        raise AssertionError(f"non-finite loss {step_losses}")
    if trainer.step != 1 + TIMED_STEPS:
        raise AssertionError(f"optimizer count {trainer.step}")
    step_ms = 1e3 * sum(times) / len(times)
    print(f"# phase {phase}: {card}: {stage} {1e3 / step_ms:.3f} steps/s, "
          f"{STAGE2_BATCH * 1e3 / step_ms:.2f} crops/s (batch "
          f"{STAGE2_BATCH}x{STAGE2_POINTS}, {TIMED_STEPS} timed steps "
          f"{[round(t * 1e3, 1) for t in times]} ms, warm-up "
          f"{warm * 1e3:.1f} ms); peak memory {peak / 2**30:.2f} GiB; "
          f"losses {[round(v, 5) for v in step_losses]}; launches {got}",
          flush=True)
    _profile(lambda: trainer.step_fn(batches[-1], trainer.generator,
                                     trainer.bn_sched(0)),
             step_ms, f"phase {phase} profile", "step")
    moved = [k for k, v in model.state_dict().items()
             if k in frozen and not torch.equal(v, frozen[k])]
    if moved:
        raise AssertionError(f"{stage} steps changed frozen {moved[:5]}")
    if stage == "ioun":
        print(f"#   the {len(frozen)} trunk tensors are bit-unchanged after "
              f"{trainer.step} IOUN steps", flush=True)
    return launches


def _stage2_small(host) -> None:
    """Phase 11: one RCNN and one IOUN step on 8 crops, GPU vs CPU."""
    from ws3d_tpu_torch.training.trainer import (batch_to_device,
                                                 rcnn_gradients, step_inputs,
                                                 trainable_parameters)
    t0 = time.perf_counter()
    for stage in ("rcnn", "ioun"):
        cfg = _stage2_cfg(stage)
        small = {k: v[:8] for k, v in host[stage].items()}
        res = []
        for device in ("cuda", "cpu"):
            m = _stage2_model(cfg, device)
            loss, _, grads = rcnn_gradients(
                m, cfg, stage,
                batch_to_device(small, device, step_inputs(stage, small)),
                None, 0.1, trainable_parameters(m, stage))
            res.append((float(loss), {k: g.cpu() for k, g in grads.items()}))
        (gl, gg), (cl, cg) = res
        rel = abs(gl - cl) / abs(cl)
        if not rel <= 1e-3:
            raise AssertionError(f"{stage} step loss GPU {gl} vs CPU {cl}")
        worst = ("", 0.0)
        for k, g in gg.items():
            scale = cg[k].abs().max().item()
            e = (g - cg[k]).abs().max().item()
            if not e <= 1e-3 * scale:
                raise AssertionError(f"{stage} gradient {k}: GPU vs CPU "
                                     f"{e:.3g} of {scale:.3g}")
            if scale:
                worst = max(worst, (k, e / scale), key=lambda x: x[1])
        print(f"# phase 11: {stage} step on 8 crops GPU vs CPU plain: loss "
              f"{gl:.6f} vs {cl:.6f} (rel {rel:.3g}); worst gradient "
              f"{worst[0]} {worst[1]:.3g} of its largest magnitude",
              flush=True)
    print(f"# phase 11: {time.perf_counter() - t0:.1f} s", flush=True)


def _window_phases(model, pts, crop_call, fp_calls, per_kernel) -> dict:
    """Phase 12: kernels 10 and 8 on the inference batch's crop and FP
    inputs, then through their entry points; returns the launch counts of
    those entry-point runs."""
    import torch
    from ws3d_tpu_torch.ops import _kernels, crop_gather, interpolate
    t0 = time.perf_counter()
    xyz, ch, centers, radius, k, grouped = crop_call[:6]
    B, N, _ = xyz.shape
    tiles = N // crop_gather.TILE
    ref_v, ref_c = crop_gather.crop_gather_cuda(xyz, ch, centers, radius, k,
                                                grouped)              # kernel 5
    for W in (32, 1, tiles):
        vals, cnt = crop_gather.crop_gather_cuda(xyz, ch, centers, radius, k,
                                                 grouped, W)
        if not (torch.equal(vals, ref_v) and torch.equal(cnt, ref_c)):
            raise AssertionError(f"kernel 10 at z_window {W} differs from "
                                 f"kernel 5")
        fits = int(_crop_windows(xyz, centers, radius, W)[2].sum())
        print(f"#   kernel 10 z_window {W}: bit-equal to kernel 5; {fits} of "
              f"{B * centers.shape[1]} centres fit", flush=True)
        # the kernel table keeps the JAX default, W = 32
        _compare_calls([("crop_gather_cuda", [*crop_call[:6], W], {})],
                       per_kernel if W == 32
                       else {"crop_gather_window": _fresh()},
                       "inference_inputs")
    rows = _compare_calls([("three_interpolate_window_cuda", list(a), {})
                           for a in fp_calls], per_kernel, "inference_inputs")
    # kernel 8 beside kernel 4 on the same inputs, in turns: CUDA events and
    # the device time queued behind a sleep kernel
    t8 = [0.0, 0.0]
    t4 = [0.0, 0.0]
    for a in fp_calls:
        for kern, acc in (
                (lambda: interpolate.three_interpolate_window_cuda(*a), t8),
                (lambda: interpolate.three_interpolate_cuda(*a), t4),
                (lambda: interpolate.three_interpolate_cuda(*a), t4),
                (lambda: interpolate.three_interpolate_window_cuda(*a), t8)):
            acc[0] += cuda_ms(kern, 5) / 2
            acc[1] += device_ms(kern, 5) / 2
    print(f"#   kernel 8 over the {len(fp_calls)} FP calls: events "
          f"{sum(r[2] for r in rows):.4f} ms (replayed {t8[0]:.4f}), device "
          f"{t8[1]:.4f} ms queued; kernel 4 on the same inputs: events "
          f"{t4[0]:.4f} ms, device {t4[1]:.4f} ms queued; bound "
          f"{sum(r[3] for r in rows):.4f} ms", flush=True)

    # each through its entry point
    _kernels.reset_launch_counts()
    vals, cnt = crop_gather.crop_gather(xyz, ch, centers, radius, k, grouped,
                                        z_window=32,
                                        center_z=centers[..., 1].contiguous())
    torch.cuda.synchronize()
    entry = {"crop_window_entry": dict(_kernels.LAUNCHES)}
    if not (torch.equal(vals, ref_v) and torch.equal(cnt, ref_c)):
        raise AssertionError("crop_gather(z_window=32) differs from kernel 5")
    fps = [m for name, m in model.rpn.backbone.named_children()
           if name.startswith("fp_")]
    with torch.no_grad():
        ref = model.rpn_forward({"pts_input": pts})
        for m in fps:
            m.sorted_points = True
        _kernels.reset_launch_counts()
        out = model.rpn_forward({"pts_input": pts})
        torch.cuda.synchronize()
    entry["fp_sorted_entry"] = dict(_kernels.LAUNCHES)
    for m in fps:
        m.sorted_points = False
    for key in ("rpn_cls", "rpn_reg"):
        err = (out[key] - ref[key]).abs().max().item()
        if not err <= 1e-5 * ref[key].abs().max().item():
            raise AssertionError(f"sorted_points FP changed {key} by {err}")
    want = {"crop_window_entry": ("crop_gather_window", 1),
            "fp_sorted_entry": ("three_interpolate_window", len(fps))}
    for path, (key, count) in want.items():
        if entry[path][key] != count:
            raise AssertionError(f"{path} launched {key} "
                                 f"{entry[path][key]} times, not {count}")
    print(f"# phase 12: kernels 10 and 8 on the inference batch's inputs and "
          f"through their entry points (crop_gather 1, FP modules "
          f"{entry['fp_sorted_entry']['three_interpolate_window']} launches; "
          f"the RPN outputs unchanged) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return entry


def _fresh() -> dict:
    return {"err": 0.0, "ms": 0.0, "plain": 0.0, "bound": 0.0,
            "by_bytes": 0.0, "ms_by_path": {}}


def _db_scene(model, cfg, sample, device, database_len: int = 0):
    """One scene of the proposal-database path: (records, device-stage
    seconds, host-loop seconds)."""
    import torch
    from ws3d_tpu_torch.tools.generate_box_dataset import (propose_and_crop,
                                                           scene_records)
    t0 = time.perf_counter()
    out = propose_and_crop(
        model, cfg, torch.from_numpy(sample["pts_input"]).to(device),
        torch.from_numpy(sample["valid"]).to(device),
        score_thresh=DB_SCORE_THRESH, max_proposals=DB_MAX_PROPOSALS,
        max_crop=DB_MAX_CROP)
    arrays = [o.cpu().numpy() for o in out]
    if device == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    records, _ = scene_records(sample, *arrays, DB_MAX_CROP, database_len)
    return records, t1 - t0, time.perf_counter() - t1


def _db_phases(card, per_kernel) -> dict:
    """Phases 13-14; returns the launch counts of the database path."""
    import numpy as np
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import (BoxPlaceDataset, RPNDataset,
                                         SyntheticKitti)
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.tools.generate_box_dataset import (BENCH_WEIGHTS,
                                                           load_rpn,
                                                           propose_and_crop)
    from ws3d_tpu_torch.training import Trainer
    from ws3d_tpu_torch.training.trainer import batch_to_device, step_inputs

    cfg = load_config()
    model = load_rpn(cfg, "cuda", [BENCH_WEIGHTS])
    P = int(cfg.RPN.NUM_POINTS)
    ds = RPNDataset(SyntheticKitti(num_scenes=DB_SCENES,
                                   points_per_scene=18000, seed=0),
                    cfg, mode="EVAL", seed=0)
    t0 = time.perf_counter()
    first = ds.get_whole_scene(0, max_points=P)
    _db_scene(model, cfg, first, "cuda")                        # warm-up
    print(f"# phase 13: warm-up scene in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # ---- 13. the database path: 16 scenes, timed
    database, t_load, t_dev, t_host = [], 0.0, 0.0, 0.0
    padded = 0
    _kernels.reset_launch_counts()
    t_all = time.perf_counter()
    with Recorder(only=("ball_query_wrap_cuda",)) as rec:
        for i in range(DB_SCENES):
            t0 = time.perf_counter()
            sample = ds.get_whole_scene(i, max_points=P)
            t_load += time.perf_counter() - t0
            padded += int(sample["n_valid"]) < P
            records, dev, host = _db_scene(model, cfg, sample, "cuda",
                                           len(database))
            if i == 0:
                first_records = records
            database += records
            t_dev += dev
            t_host += host
    t_all = time.perf_counter() - t_all
    launches = dict(_kernels.LAUNCHES)
    if launches["ball_query_wrap"] != DB_SCENES or len(rec.calls) \
            != DB_SCENES:
        raise AssertionError(f"{launches['ball_query_wrap']} kernel-6w "
                             f"launches for {DB_SCENES} scenes")
    missing = [k for k in DB_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"the database path launched no {missing}")
    if not database:
        raise AssertionError("the database path wrote no record")
    pts_ok = all(np.isfinite(r["cur_box_point"]).all()
                 and r["cur_box_point"].shape[0] > 5 for r in database)
    if not pts_ok:
        raise AssertionError("a record has non-finite or too few points")
    n_fg = sum(r["foreground_flag"] for r in database)
    print(f"# phase 13: {card}: device stage {DB_SCENES / t_dev:.2f} "
          f"scenes/s ({1e3 * t_dev / DB_SCENES:.1f} ms a scene), whole loop "
          f"{DB_SCENES / t_all:.2f} scenes/s (loading {1e3 * t_load:.0f} ms, "
          f"device stage {1e3 * t_dev:.0f} ms, host records "
          f"{1e3 * t_host:.0f} ms for {DB_SCENES} scenes of {P} points, "
          f"{padded} padded); {len(database)} records ({n_fg} foreground); "
          f"launches {launches}", flush=True)
    rows = _compare_calls(rec.calls, per_kernel, "proposal_db")
    print(f"# phase 13: kernel 6w by launch ({len(rows)} scenes, one a "
          f"scene), ms (device ms queued): "
          + "; ".join(f"{ms:.4f} ({note.split('(device ')[1].split()[0]})"
                      for _, note, ms, _ in rows)
          + f"; bound {rows[0][3]:.4f} ms a scene ({rows[0][1]})",
          flush=True)
    print(f"# phase 13: kernel 6w on the first scene's points shuffled: "
          + _shuffled("ball_query_wrap_cuda", [rec.calls[0][1]]), flush=True)
    del rec
    pts = torch.from_numpy(first["pts_input"]).cuda()
    valid = torch.from_numpy(first["valid"]).cuda()
    _profile(lambda: propose_and_crop(model, cfg, pts, valid,
                                      DB_SCORE_THRESH, DB_MAX_PROPOSALS,
                                      DB_MAX_CROP),
             1e3 * t_dev / DB_SCENES, "phase 13 profile", "scene")

    # ---- 14. one scene GPU vs CPU, and an RCNN step on the database
    t0 = time.perf_counter()
    cpu_model = load_rpn(load_config(), "cpu", [BENCH_WEIGHTS])
    cpu_records, _, _ = _db_scene(cpu_model, cfg, first, "cpu")
    _check_records(first_records, cpu_records)
    print(f"# phase 14: one scene GPU vs CPU plain: {len(first_records)} "
          f"records agree ({time.perf_counter() - t0:.1f} s)", flush=True)
    del cpu_model, model
    t0 = time.perf_counter()
    cfg2 = _stage2_cfg("rcnn")
    model2 = _stage2_model(cfg2, "cuda")
    ds2 = BoxPlaceDataset(database, cfg2, mode="TRAIN",
                          npoints=STAGE2_POINTS, seed=0)
    batch = next(ds2.batches(CASCADE_CLI_BATCH, steps=1))
    trainer = Trainer(model2, cfg2, total_steps=1000, stage="rcnn", seed=0,
                      log_fn=lambda msg: print("#   " + msg, flush=True))
    aux = trainer.step_fn(batch_to_device(batch, "cuda",
                                          step_inputs("rcnn", batch)),
                          trainer.generator, trainer.bn_sched(0))
    loss = float(aux["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"RCNN step on the database: loss {loss}")
    print(f"# phase 14: one RCNN step on {CASCADE_CLI_BATCH} crops of the "
          f"generated database ({len(ds2)} samples): loss {loss:.6f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return launches


def _eval_phase(card) -> dict:
    """Phase 15: run_eval of the port's eval_auto on EVAL_SCENES scenes of
    the inference path at batch BATCH (a warm-up run, then the timed one),
    its gates, and the first scene again on the CPU; returns the timed
    run's launch counts."""
    import logging
    import tempfile
    import torch
    from ws3d_tpu_torch import native
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.eval.kitti_ap import get_official_eval_result
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.tools.eval_auto import run_eval
    from ws3d_tpu_torch.weights import load_npz

    t0 = time.perf_counter()
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    model = build_model(cfg)
    load_npz(model, WEIGHTS)
    src = SyntheticKitti(num_scenes=EVAL_SCENES, points_per_scene=20000,
                         seed=3)
    ds = RPNDataset(src, cfg, mode="EVAL", seed=0)
    quiet = logging.getLogger("chip_smoke.eval_auto.quiet")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    log = logging.getLogger("chip_smoke.eval_auto")
    log.setLevel(logging.INFO)
    log.propagate = False
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(_CommentFormatter())
    log.addHandler(handler)
    with tempfile.TemporaryDirectory() as tmp:
        run_eval(model, cfg, src, ds, quiet, scenes=EVAL_SCENES, batch=BATCH,
                 output_dir=os.path.join(tmp, "warm"), no_ap=True)
        torch.cuda.synchronize()
        print(f"# phase 15: {card}: the auto-annotator on {EVAL_SCENES} "
              f"scenes at batch {BATCH} (warm-up run in "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        stats = {}
        _kernels.reset_launch_counts()
        t1 = time.perf_counter()
        try:
            ret = run_eval(model, cfg, src, ds, log, scenes=EVAL_SCENES,
                           batch=BATCH, output_dir=os.path.join(tmp, "gpu"),
                           stats=stats)
            torch.cuda.synchronize()
        finally:
            log.removeHandler(handler)
        wall = time.perf_counter() - t1
        launches = dict(_kernels.LAUNCHES)
        missing = [k for k in INFERENCE_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"eval_auto launched no {missing}")
        if stats["detections"] == 0:
            raise AssertionError("eval_auto: no scene has a detection")
        sec = stats["seconds"]
        print(f"# phase 15: {card}: {stats['detections']} detections over "
              f"{stats['scenes']} scenes; Car 3D AP e/m/h "
              f"{ret['Car_3d_easy']:.4f} / {ret['Car_3d_moderate']:.4f} / "
              f"{ret['Car_3d_hard']:.4f}; seconds: inference "
              f"{sec['inference']:.3f}, txt files {sec['txt']:.4f}, AP "
              f"harness {sec['ap']:.3f}, the whole run {wall:.3f} (loading "
              f"the scenes the rest); launches {launches}", flush=True)

        # the AP through the native library and through NumPy
        if not native.available():
            raise AssertionError("the host library csrc/libws3d_host.so "
                                 "cannot be built or loaded")
        gt, dt = stats["annos"]
        t1 = time.perf_counter()
        ap_native = get_official_eval_result(gt, dt, cfg.CLASSES,
                                             native=True)[1]
        t_native = time.perf_counter() - t1
        t1 = time.perf_counter()
        ap_numpy = get_official_eval_result(gt, dt, cfg.CLASSES,
                                            native=False)[1]
        t_numpy = time.perf_counter() - t1
        diff = max(abs(float(ap_native[k]) - float(ap_numpy[k]))
                   for k in ap_native)
        if ap_native.keys() != ap_numpy.keys() or not diff <= 1e-6:
            raise AssertionError(f"AP native vs NumPy differ by {diff}")
        print(f"# phase 15: AP native vs NumPy: max|diff| {diff:.3g} over "
              f"{len(ap_native)} entries (native {t_native:.3f} s, NumPy "
              f"{t_numpy:.3f} s)", flush=True)

        # the first scene on the CPU
        t1 = time.perf_counter()
        cpu_model = build_model(cfg, device="cpu")
        load_npz(cpu_model, WEIGHTS)
        run_eval(cpu_model, cfg, src, ds, quiet, scenes=1, batch=1,
                 output_dir=os.path.join(tmp, "cpu"), no_ap=True)
        name = sorted(os.listdir(os.path.join(tmp, "cpu", "final_result",
                                              "data")))[0]
        rows = [_txt_rows(os.path.join(tmp, side, "final_result", "data",
                                       name)) for side in ("gpu", "cpu")]
        _check_txt(*rows, float(cfg.IOUN.SCORE_THRESH))
        print(f"# phase 15: first scene GPU vs CPU plain: {len(rows[0])} vs "
              f"{len(rows[1])} detections in {name} agree "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
    return launches


class _CommentFormatter:
    """Log records as comment lines ("#   " before each line)."""

    def format(self, record) -> str:
        return "\n".join("#   " + line
                         for line in record.getMessage().splitlines())


def _txt_rows(path):
    """(N, 12) rows of a KITTI result file: bbox (4), h w l, x y z, ry,
    score (tools/diff_detections.py's columns)."""
    import numpy as np
    with open(path) as f:
        rows = [[float(v) for v in line.split()[4:]] for line in f
                if line.split()]
    return np.array(rows, np.float64).reshape(len(rows), 12)


def _match(a, b, tol: float = 2.0):
    """tools/diff_detections.py's match: greedy global-argmin pairing of
    the centres (columns 7:10) within `tol` metres."""
    import numpy as np
    if not len(a) or not len(b):
        return []
    d = np.linalg.norm(a[:, None, 7:10] - b[None, :, 7:10], axis=-1)
    pairs = []
    for _ in range(min(len(a), len(b))):
        i, j = np.unravel_index(np.argmin(d), d.shape)
        if d[i, j] > tol:
            break
        pairs.append((int(i), int(j)))
        d[i, :] = np.inf
        d[:, j] = np.inf
    return pairs


def _check_txt(a, b, score_thresh: float, tol: float = 1e-3) -> None:
    """_check_detections's rule on two result files' rows: every detection
    matched (_match) within `tol` in centre and score, unless its score lies
    within 0.02 of the threshold."""
    import numpy as np
    pairs = _match(a, b)
    for i, j in pairs:
        dc = float(np.linalg.norm(a[i, 7:10] - b[j, 7:10]))
        ds = abs(float(a[i, 11] - b[j, 11]))
        if not (dc <= tol and ds <= tol):
            raise AssertionError(f"detection {a[i].tolist()} vs "
                                 f"{b[j].tolist()}: centre {dc}, score {ds}")
    for rows, done in ((a, {i for i, _ in pairs}), (b, {j for _, j in pairs})):
        for k in range(len(rows)):
            if k not in done and abs(rows[k, 11] - score_thresh) >= 0.02:
                raise AssertionError(f"detection {rows[k].tolist()} has no "
                                     f"match")


def _check_records(a, b) -> None:
    """The same records: keys, types, dtypes, shapes and integers equal,
    floats within 1e-5."""
    import numpy as np
    if len(a) != len(b):
        raise AssertionError(f"{len(a)} vs {len(b)} records")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.keys() != y.keys():
            raise AssertionError(f"record {i}: keys differ")
        for k in x:
            u, v = x[k], y[k]
            if type(u) is not type(v):
                raise AssertionError(f"record {i} {k}: {type(u)} vs "
                                     f"{type(v)}")
            if isinstance(u, np.ndarray):
                if u.dtype != v.dtype or u.shape != v.shape:
                    raise AssertionError(f"record {i} {k}: {u.dtype}"
                                         f"{u.shape} vs {v.dtype}{v.shape}")
                if u.size and np.abs(u.astype(np.float64) - v).max() > 1e-5:
                    raise AssertionError(f"record {i} {k} differs by "
                                         f"{np.abs(u - v).max()}")
            elif u != v:
                raise AssertionError(f"record {i} {k}: {u} vs {v}")


def _profile(run, ms: float, label: str, unit: str) -> None:
    """One run under torch.profiler: device time by kernel (the
    hand-written ones first) and the device's busy share of a run timed
    without the profiler (`ms`; the profiler slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the tracer can drop the first device events after it starts (a
        # scene's first FPS launch, 11 ms): give it a throwaway kernel of a
        # few microseconds to drop instead
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(r[1] for r in rows)
    print(f"# {label}: {busy:.1f} ms of kernels in one {unit}, "
          f"{100 * busy / ms:.1f} % of the {ms:.1f} ms {unit} "
          f"({len(rows)} kernel names)")
    ours = ("fps_warp_kernel", "fps_cluster_kernel", "fused_sa_tc_kernel",
            "three_interp_kernel", "chunk_bounds_kernel",
            "crop_gather_kernel", "ball_query_kernel", "three_nn_kernel",
            "ball_query_wrap_kernel")
    rows.sort(key=lambda r: -r[1])
    for o in ours:
        mine = [r for r in rows if o in r[0]]
        if mine:
            print(f"#   {sum(r[1] for r in mine):9.3f} ms "
                  f"{sum(r[2] for r in mine):6d}x  {o} (hand-written)")
    for key, ms_k, count in rows[:14]:
        print(f"#   {ms_k:9.3f} ms {count:6d}x  {key[:90]}")
    rest = sum(r[1] for r in rows[14:])
    print(f"#   {rest:9.3f} ms in {max(len(rows) - 14, 0)} other kernels",
          flush=True)


def _check_detections(a, b, score_thresh: float) -> None:
    """Detection-level agreement: every kept box on one side has a kept box
    on the other within 0.05 m (centre) and 0.02 (score), unless its score
    lies within 0.02 of the threshold."""
    import torch
    if int(a["spilled"]) != int(b["spilled"]):
        raise AssertionError(f"spilled {int(a['spilled'])} vs "
                             f"{int(b['spilled'])}")
    for x, y in ((a, b), (b, a)):
        kx, ky = x["keep"][0], y["keep"][0]
        bx, by = x["boxes"][0][kx], y["boxes"][0][ky]
        sx, sy = x["scores"][0][kx], y["scores"][0][ky]
        for i in range(bx.shape[0]):
            if by.shape[0]:
                d = torch.linalg.norm(by[:, [0, 2]] - bx[i, [0, 2]], dim=-1)
                j = int(torch.argmin(d))
                if d[j] < 0.05 and abs(float(sy[j] - sx[i])) < 0.02:
                    continue
            if abs(float(sx[i]) - score_thresh) < 0.02:
                continue
            raise AssertionError(f"detection {bx[i].tolist()} (score "
                                 f"{float(sx[i]):.4f}) has no match")


if __name__ == "__main__":
    sys.exit(main())
