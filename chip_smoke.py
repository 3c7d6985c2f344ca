#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from ws3d_tpu_torch/csrc (nvcc, sm_90a); print
     each kernel's registers and spills, and require TF32 tensor-core
     instructions (HMMA) in all three modes of the fused SA routine (kernels
     2, 3 and 9) and bf16 ones only (HMMA.1688.F32.BF16) in each mode's bf16
     instance, no SIMT MLP routine (fused_sa_kernel), and cluster
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
 16. training with in-training validation at full width: a GT database
     from 16 scenes of SyntheticKitti(seed=3), then Trainer.train_steps
     for 1 + 4 stage-1 steps at batch 16 and 16,384 points on
     RPNDataset(TRAIN, gt_database=...) with a val_fn over 8 EVAL scenes
     every 2 steps (and after the last); then 1 + 2 RCNN steps at 800
     crops with a val_fn over a held-out tenth of phase 8's database. The
     kernel calls of one validation forward of each are held against their
     plain versions; gates: finite losses, a checkpoint per eval and the
     best one in a temporary directory, and the trainer's generator state
     and every parameter and BN buffer bit-equal just before and just
     after each validation. Prints the validation's seconds and share of
     the loop, the metrics, the pasted instances a scene, the stage-1
     step time on augmented and plain batches, a profile of the host's
     augmented and plain TRAIN batches by function, and the step time of
     a stage-1 loop whose loader builds the batches as it goes, one
     batch ahead on its prefetch thread, with and without the
     augmentation. The validation forwards' kernel times go to the
     kernels line under ms_by_path only;
 17. the inference cell in bf16 (cfg.TPU.COMPUTE_DTYPE=bfloat16; batch 16,
     16,384 points, the fitted npz): every kernel call of one batch held
     against its plain bf16 version (kernels 2 and 3 in their bf16 mode
     and kernel 4 with its bf16 store within the stated tolerances, the
     store also bit-equal to the f32 kernel's output rounded to bf16; FPS
     and the crop exact), kernel 9 in its bf16 mode on kernel 6's indices for
     each fused call (bit-equal to the fused kernel, then against its plain
     version) and through its entry point fused_sa_idx; a warm-up and timed
     batches (scenes/s, detections, n_live, spilled, which must be 0; the
     bf16 modes, and no f32 mode of kernels 2, 3 and 4, launched), one
     batch under torch.profiler; one scene on the GPU against the CPU's
     plain bf16 versions; then eval_auto on 16 scenes in f32 and in bf16
     and the port's diff_detections between the two, within stated bounds;
 18. the click-seeded annotator (ws3d_tpu_torch.tools.eval_active at its
     defaults: 16 scenes of SyntheticKitti(seed=3), --max_points 16384,
     batch 8, the fitted npz, f32): a warm-up run whose every kernel call
     (kernel 5 in its `s % cnt` mode on these unsorted scenes, FPS and
     kernels 2 and 3 on the pooled crops) is held against its plain
     version, then a timed run: scenes/s of the device pass (batches and
     their host copies) and the host's txt files and tally, hypotheses,
     live slots and V of each batch, detections, the Car 3D AP and the
     peak memory, and one run under torch.profiler; crop, FPS and both
     fused SA entries launched, at least one detection; finalize's time and
     memory at the largest slot bucket (batch 8, K 1,024); then one scene's
     batch on the GPU and on the CPU (the
     plain versions): equal keep masks, kept boxes and scores within 1e-3;
 19. one inference batch of 16 with RPN.USE_INTENSITY=False (3-channel
     scenes; SA0 runs the ball query, kernel 6, instead of a fused kernel)
     and ATTENTION=True, from seeded weights: every kernel call, kernel 6
     among them, against its plain version; a timed batch with every
     inference kernel and the ball query launched, finite boxes;
 20. tools/pointnet2_seg at its defaults (4,096 points, batch 4, the
     seeded init): one step's kernel calls (FPS, the ball query and the
     interpolation forward, the 3-NN search backward) against their plain
     versions, then two steps and five timed ones (steps/s, finite Dice
     losses, all four kernels launched);
 21. ws3d_tpu_torch.tools.gpu_selftest: every kernel against its plain
     version at tools/tpu_selftest.py's shapes and beside them;
 22. scale-out (ws3d_tpu_torch.parallel) on the one card, the train-step
     parities under torch.use_deterministic_algorithms (without it the
     backward's atomics make two plain Trainers differ; printed): (a) one
     NCCL rank through parallel.launch runs phase 6's data-parallel
     stage-1 Trainer (a warm-up and 3 timed steps at batch 16; its
     parameters and BN statistics within 1e-5 of the plain Trainer's from
     the same state and batches, steps/s beside the plain Trainer's and
     phase 6's) and eval_auto's run_eval on phase 15's 16 scenes (the
     single run's detections, txt files within 1e-3); (b) two gloo ranks
     sharing cuda:0 with CUDA tensors, DP_RATIO 0: the stage-1 step at
     batch 16 (8 scenes a rank) and the IOUN step at 800 crops (400 a
     rank), each on identical shards within 1e-5 of the single-process
     step on one shard, on the whole batch its loss within 5 % (IOUN
     15 %) of the single step's and the replicas bit-equal, the IOUN trunk
     bit-unchanged; then phase 3's batch of 16 through
     data_parallel_infer, the stage-2 budget pooled over both ranks: the
     kept slots and their packed rows within 1e-3 of the single batch's,
     n_live equal, spilled 0, every inference kernel
     launched in each rank (the counts come back from the ranks). Times
     of (b) are labelled as two ranks sharing one card, not a scaling
     figure;
 23. print the kernel table, the card's name and power limit, and the
     result line. The calls of phases 18-20 enter the table's ms_by_path
     and launches_by_path only; phase 22's launches enter
     launches_by_path under paths named scaleout_*.

Prints nothing of the result and exits 2 without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import contextlib
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
# TF32 and bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12

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
# the bf16 modes (cfg.TPU.COMPUTE_DTYPE=bfloat16) of kernels 2, 3, 9 and 4
BF16_MODES = ("fused_sa_window", "fused_sa_full", "fused_sa_idx",
              "three_interpolate")
KERNELS.update({f"{k}_bf16": KERNELS[k] for k in BF16_MODES})
INFERENCE_KERNELS = ("fps", "fused_sa_window", "fused_sa_full",
                     "three_interpolate", "crop_gather")
BF16_INFERENCE_KERNELS = ("fps", "fused_sa_window_bf16", "fused_sa_full_bf16",
                          "three_interpolate_bf16", "crop_gather")
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
# phase 16: training with validation (the tools' validation sets: 8
# synthetic scenes, a tenth of the database)
RPN_VAL_STEPS = 4           # stage-1 steps after the first
RCNN_VAL_STEPS = 2
VAL_EVERY = 2
VAL_SCENES = 8
PREFETCH_STEPS = 6          # stage-1 steps a loop with the loader prefetching
SCALEOUT_STEPS = 3          # phase 22: timed data-parallel steps
HOST_PROFILE = ("get_sample", "apply_gt_aug", "greedy_furthest_point_sample",
                "gaussian_weak_labels", "sample_npoints", "valid_point_mask",
                "augment_scene")


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
        bf16 = bool(kw.get("bf16"))
        out = fused_sa.fused_sa_cuda(*args, **kw)
        ref = fused_sa.fused_sa_plain(xyz, feat, new_xyz, radius, nsample,
                                      kernels, biases, bf16)
        err = (out - ref).abs().max().item()
        gate = ""
        if bf16:
            gate = "; " + _bf16_gate(out, ref, fused_sa.fused_sa_plain(
                xyz, feat, new_xyz, radius, nsample, kernels, biases),
                f"fused_sa window={window} {tuple(xyz.shape)}")
        # f32 sums over <= 515 terms in another order than the plain matmul
        elif not err <= 1e-3 + 1e-4 * ref.abs().max().item():
            raise AssertionError(f"fused_sa window={window} "
                                 f"{tuple(xyz.shape)}: max|diff| {err}")
        key = ("fused_sa_window" if window else "fused_sa_full") + (
            "_bf16" if bf16 else "")
        ms = cuda_ms(lambda: fused_sa.fused_sa_cuda(*args, **kw), 5)
        plain = cuda_ms(lambda: fused_sa.fused_sa_plain(
            xyz, feat, new_xyz, radius, nsample, kernels, biases, bf16), 1)
        B, P, C = feat.shape
        M = new_xyz.shape[1]
        widths = [C + 3] + [int(k.shape[1]) for k in kernels]
        mlp_ops = 2 * B * M * nsample * sum(
            a * b for a, b in zip(widths[:-1], widths[1:]))
        scanned = _scanned_points(xyz, new_xyz, radius, nsample)
        nbytes = 4 * (B * P * 3 + B * P * C + B * M * 3 + B * M * widths[-1]
                      + sum(k.numel() + b.numel()
                            for k, b in zip(kernels, biases)))
        # the MLP on the tensor cores (three TF32 passes, or one in bf16),
        # the search on the SIMT cores; the larger of the two bounds
        ops = [(mlp_ops, PEAK_BF16, "bf16 ops") if bf16 else
               (3 * mlp_ops, PEAK_TF32, "3xTF32 ops"),
               (9 * scanned, PEAK_F32, "search ops")]
        return (key, err, ms, plain, nbytes, ops,
                f"B{B} P{P} M{M} C{C} S{nsample} {widths} "
                + _plan_note(feat, new_xyz, nsample, widths) + gate)

    if name == "three_interpolate_cuda":
        # the forward's workspace, if it passed one, is left out: a call
        # here allocates its own, as the forward does
        args = args[:3]
        unknown, known, feats = args
        bf16 = {"bf16_out": bool(kw.get("bf16_out"))}
        out = interpolate.three_interpolate_cuda(*args, **bf16).float()
        ref = interpolate.three_interpolate_plain(*args, **bf16).float()
        err = (out - ref).abs().max().item()
        # f32 sums in another order; a bf16 store may round them to either
        # side: one bf16 ulp of each value (at most 2^-7 of it) besides
        tol = 1e-4 + 1e-5 * ref.abs().max().item()
        over = (out - ref).abs() > tol + (
            2.0 ** -7 * ref.abs() if bf16["bf16_out"] else 0.0)
        if bool(over.any()):
            raise AssertionError(f"three_interpolate {bf16} "
                                 f"{tuple(unknown.shape)}: max|diff| {err}")
        # the bf16 store is the f32 kernel's result rounded to nearest even,
        # bit for bit (a truncating store, or one that rounds the weights
        # or features first, differs)
        if bf16["bf16_out"] and not torch.equal(
                interpolate.three_interpolate_cuda(*args, bf16_out=True),
                interpolate.three_interpolate_cuda(*args).to(torch.bfloat16)):
            raise AssertionError(f"three_interpolate bf16 store "
                                 f"{tuple(unknown.shape)}: not the f32 "
                                 f"result rounded to nearest even")
        ms = cuda_ms(lambda: interpolate.three_interpolate_cuda(*args, **bf16),
                     5)
        plain = cuda_ms(lambda: interpolate.three_interpolate_plain(
            *args, **bf16), 1)
        B, n, _ = unknown.shape
        m, C = feats.shape[1], feats.shape[2]
        nbytes = (4 * (B * n * 3 + B * m * 3 + B * m * C)
                  + (2 if bf16["bf16_out"] else 4) * B * n * C)
        # the pairs these inputs need tested (~10 operations each): on
        # z-sorted clouds those inside each query's z window (kernel 8's
        # search), else every pair; then the weighted three-row sum
        dense = B * n * m * 10 + B * n * C * 5
        if _z_sorted(unknown) and _z_sorted(known):
            ops = (10 * int(interpolate.window_search(unknown, known)[2].sum())
                   + B * n * C * 5)
        else:
            ops = dense
        return ("three_interpolate_bf16" if bf16["bf16_out"] else
                "three_interpolate", err, ms, plain, nbytes, ops,
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
        bf16 = bool(kw.get("bf16"))
        out = fused_sa_idx.fused_sa_idx_cuda(*args, **kw)
        ref = fused_sa_idx.fused_sa_idx_plain(idx, xyz, feat, new_xyz,
                                              kernels, biases, bf16)
        err = (out - ref).abs().max().item()
        gate = ""
        if bf16:
            f32 = fused_sa_idx.fused_sa_idx_plain(idx, xyz, feat, new_xyz,
                                                  kernels, biases)
            gate = "; " + _bf16_gate(out, ref, f32,
                                     f"fused_sa_idx {tuple(idx.shape)}")
        # f32 sums in another order than the plain matmul
        elif not err <= 1e-4 * ref.abs().max().item() + 1e-6:
            raise AssertionError(f"fused_sa_idx {tuple(idx.shape)}: "
                                 f"max|diff| {err}")
        ms = cuda_ms(lambda: fused_sa_idx.fused_sa_idx_cuda(*args, **kw), 5)
        plain = cuda_ms(lambda: fused_sa_idx.fused_sa_idx_plain(
            idx, xyz, feat, new_xyz, kernels, biases, bf16), 1)
        B, P, C = feat.shape
        M, S = idx.shape[1], idx.shape[2]
        widths = [C + 3] + [int(k.shape[1]) for k in kernels]
        nbytes = 4 * (B * P * 3 + B * P * C + B * M * 3 + B * M * S
                      + B * M * widths[-1]
                      + sum(k.numel() + b.numel()
                            for k, b in zip(kernels, biases)))
        # the MLP on the tensor cores: three TF32 passes, or one in bf16
        mlp_ops = 2 * B * M * S * sum(a * b for a, b in zip(widths[:-1],
                                                            widths[1:]))
        ops = [(mlp_ops, PEAK_BF16, "bf16 ops") if bf16 else
               (3 * mlp_ops, PEAK_TF32, "3xTF32 ops")]
        return ("fused_sa_idx_bf16" if bf16 else "fused_sa_idx", err, ms,
                plain, nbytes, ops,
                f"B{B} P{P} M{M} C{C} S{S} {widths} "
                + _plan_note(feat, new_xyz, S, widths) + gate)
    raise KeyError(name)


def _bf16_gate(out, ref, f32, what: str) -> str:
    """The gate of the fused SA's bf16 mode against its plain bf16 version
    `ref` (f32: the plain f32 version): the same exact products summed in
    another order can move an activation's bf16 rounding by one ulp, so an
    output may move by up to one bf16 ulp of the largest one: max|diff| <=
    1e-3 + 2^-7 max|ref|. Such moves are rare: the kernel must sit ten times
    closer to the bf16 arithmetic than bf16 is to f32 on average, mean|out -
    ref| <= 0.1 mean|ref - f32|. Returns the numbers; raises past a gate."""
    d = (out - ref).abs()
    err, mean = d.max().item(), d.mean().item()
    scale = ref.abs().max().item()
    rounding = (ref - f32).abs().mean().item()
    tol = 1e-3 + 2 ** -7 * scale
    note = (f"bf16 gate: max|diff| {err:.3g} (<= {tol:.3g}), "
            f"mean {mean:.3g} (<= {0.1 * rounding:.3g}), "
            f"{100 * (out == ref).float().mean().item():.2f} % bit-equal")
    if not (err <= tol and mean <= 0.1 * rounding):
        raise AssertionError(f"{what}: {note}")
    return note


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
    three modes (kernels 3, 2 and 9) and bf16 HMMA (HMMA.1688.F32.BF16) in
    each mode's bf16 instance, and no SIMT MLP routine may be left; the FPS
    cluster kernel must have UCGABAR."""
    import re
    import shutil

    def kernel_name(mangled):
        # <length><name> in the mangled symbol, then I...E for a template
        # whose arguments are L<type><N>E each (Li0E an int 0, Lb1E a bool
        # true; a hash before the name may end in digits: try each tail of
        # the run) -> name<N,...>
        for m in re.finditer(r"\d+", mangled):
            i = m.end()
            for k in range(m.start(), i):
                n = int(mangled[k:i])
                if mangled[i:i + n].endswith("_kernel"):
                    t = re.match(r"I((?:L[a-z]+\d+E)+)E", mangled[i + n:])
                    args = re.findall(r"L[a-z]+(\d+)E", t.group(1)) if t \
                        else []
                    return mangled[i:i + n] + (f"<{','.join(args)}>" if args
                                               else "")
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
        # <mode,0>: 3xTF32, TF32 HMMA only; <mode,1>: the bf16 mode,
        # HMMA.1688.F32.BF16 only
        for bf16, want in ((0, "TF32"), (1, "HMMA.1688.F32.BF16")):
            ops = counts.get(f"fused_sa_tc_kernel<{mode},{bf16}>", {})
            hmma = [op for op in ops if op.startswith("HMMA")]
            if not hmma or not all(want in op for op in hmma):
                raise AssertionError(f"fused_sa_tc_kernel<{mode},{bf16}> has "
                                     f"the HMMA instructions {hmma}, not "
                                     f"only {want}")
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
    # and bf16 GEMMs (none on the port's path) summed in f32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    launches["train"], phase6_ms = _train_phases(card, per_kernel)

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

    # ---- 16. training with validation
    launches.update(_train_val_phase(card, per_kernel))

    # ---- 17. the inference cell in bf16
    launches.update(_bf16_phase(card, per_kernel))

    # ---- 18. the click-seeded annotator
    launches["eval_active"] = _active_phase(card, per_kernel)

    # ---- 19. one batch with USE_INTENSITY=False and ATTENTION=True
    launches["no_intensity_attention"] = _flags_phase(card, per_kernel)

    # ---- 20. the segmentation smoke trainer
    launches["pointnet2_seg"] = _seg_phase(card, per_kernel)

    # ---- 21. the GPU self-test
    _selftest_phase(card)

    # ---- 22. scale-out: NCCL at world size 1, two gloo ranks on the card
    launches.update(_scaleout_phase(card, phase6_ms))

    # ---- 23. report
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


def _compare_aside(calls, per_kernel, path: str, totals=()) -> list:
    """_compare_calls, with the times of kernels not in `totals` kept out of
    the kernels line's totals (ms, plain_ms, bound_ms cover the phase that
    measured their main-path shapes first); errors and ms_by_path take
    every call."""
    aside = {k: _fresh() for k in per_kernel}
    rows = _compare_calls(calls, aside, path)
    for key, agg in aside.items():
        if key in totals:
            for f in ("ms", "plain", "bound", "by_bytes"):
                per_kernel[key][f] += agg[f]
        per_kernel[key]["err"] = max(per_kernel[key]["err"], agg["err"])
        by_path = per_kernel[key]["ms_by_path"]
        for p, ms in agg["ms_by_path"].items():
            by_path[p] = by_path.get(p, 0.0) + ms
    return rows


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


def _train_phases(card, per_kernel) -> tuple:
    """Phases 5-7 on the stage-1 train step at batch 16; returns the
    training path's launch counts and phase 6's ms a step."""
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
    return launches, step_ms


def _stage2_cfg(stage: str):
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.tools.train_cascade import configure
    cfg = load_config()
    configure(cfg, stage, STAGE2_POINTS)
    return cfg


def _stage2_model(cfg, device):
    """The stage-2 model with the fitted npz's RCNN trunk; an IOUN model's
    cascade keeps its seeded init (parallel.dryrun.stage2_model)."""
    from ws3d_tpu_torch.parallel.dryrun import stage2_model
    return stage2_model(cfg, device)


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
    from ws3d_tpu_torch.tools.diff_detections import load_txt
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
        rows = [load_txt(os.path.join(tmp, side, "final_result", "data",
                                      name)) for side in ("gpu", "cpu")]
        _check_txt(*rows, float(cfg.IOUN.SCORE_THRESH))
        print(f"# phase 15: first scene GPU vs CPU plain: {len(rows[0])} vs "
              f"{len(rows[1])} detections in {name} agree "
              f"({time.perf_counter() - t1:.1f} s)", flush=True)
    return launches


def _bf16_phase(card, per_kernel) -> dict:
    """Phase 17 (see the module docstring); returns the launch counts of
    the timed bf16 batches and of kernel 9's bf16 entry point."""
    import logging
    import tempfile
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.ops import _kernels, ball_query, fused_sa_idx
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    from ws3d_tpu_torch.tools.diff_detections import diff
    from ws3d_tpu_torch.tools.eval_auto import run_eval
    from ws3d_tpu_torch.weights import load_npz

    t0 = time.perf_counter()
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_model(cfg)
    load_npz(model, WEIGHTS)
    fn = make_two_stage_fn(model, cfg)
    src = SyntheticKitti(num_scenes=BATCH * 2, points_per_scene=20000,
                         seed=3)
    ds = RPNDataset(src, cfg, mode="EVAL", npoints=cfg.RPN.NUM_POINTS,
                    seed=0)
    bufs = [torch.from_numpy(b["pts_input"]).cuda()
            for b in ds.batches(batch_size=BATCH, steps=2)]

    # every kernel call of one batch against its plain (bf16) version
    with Recorder(outputs=True) as rec:
        fn(bufs[0])
        torch.cuda.synchronize()
    # FPS and the crop run phase 2's calls again: their times stay out of
    # the kernels line's totals
    bf16_keys = [f"{k}_bf16" for k in BF16_MODES]
    rows = _compare_aside(rec.calls, per_kernel, "inference_bf16", bf16_keys)
    for key in ("fused_sa_window_bf16", "fused_sa_full_bf16",
                "three_interpolate_bf16"):
        kr = [r for r in rows if r[0] == key]
        print(f"# phase 17: {key} by launch ({len(kr)} a batch): "
              + "; ".join(f"{note} {ms:.4f} ms (bound {b:.4f})"
                          for _, note, ms, b in kr), flush=True)
    # kernel 9's bf16 mode on kernel 6's indices for each fused call
    idx_calls = []
    for (name, a, kw), out in zip(rec.calls, rec.outputs):
        if name != "fused_sa_cuda":
            continue
        xyz, feat, new_xyz, radius, nsample, kernels, biases, window = a
        idx = ball_query.ball_query_multi_cuda([radius], [nsample], xyz,
                                               new_xyz)[0]
        got = fused_sa_idx.fused_sa_idx_cuda(xyz, feat, new_xyz, idx,
                                             kernels, biases, bf16=True)
        # the same rows through the same routine: bit-equal
        if not torch.equal(got, out):
            raise AssertionError(f"kernel 9 (bf16) differs from the fused "
                                 f"kernel (window={window}) by "
                                 f"{(got - out).abs().max().item()}")
        idx_calls.append(("fused_sa_idx_cuda",
                          [xyz, feat, new_xyz, idx, kernels, biases],
                          {"bf16": True}))
    _compare_aside(idx_calls, per_kernel, "inference_bf16", bf16_keys)
    _kernels.reset_launch_counts()
    with torch.no_grad():
        for _, a, kw in idx_calls:
            fused_sa_idx.fused_sa_idx(*a, **kw)
    torch.cuda.synchronize()
    entry = dict(_kernels.LAUNCHES)
    if entry["fused_sa_idx_bf16"] != len(idx_calls):
        raise AssertionError(f"fused_sa_idx(bf16=True) launched kernel 9 "
                             f"{entry['fused_sa_idx_bf16']} times")
    print(f"# phase 17: {len(rec.calls)} kernel calls of a bf16 batch and "
          f"{len(idx_calls)} kernel-9 calls (bit-equal to the fused "
          f"kernel's) compared in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del rec, idx_calls

    # the timed batches
    _kernels.reset_launch_counts()
    t1 = time.perf_counter()
    fn(bufs[0])
    torch.cuda.synchronize()
    warm = time.perf_counter() - t1
    times, outs = [], []
    for it in range(TIMED_ITERS):
        t1 = time.perf_counter()
        outs.append(fn(bufs[(it + 1) % len(bufs)]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    launches = dict(_kernels.LAUNCHES)
    missing = [k for k in BF16_INFERENCE_KERNELS if launches[k] == 0]
    f32 = [k for k in BF16_MODES if launches[k]]
    if missing or f32:
        raise AssertionError(f"the bf16 path launched no {missing}, and "
                             f"f32 modes {f32}")
    spilled = max(int(o["spilled"]) for o in outs)
    packed, keep = outs[-1]["packed"], outs[-1]["keep"]
    if spilled or not (bool(torch.isfinite(packed[..., 0:7]).all()) and
                       bool(torch.isfinite(packed[..., 7][keep]).all())):
        raise AssertionError(f"bf16: spilled {spilled} or non-finite values "
                             f"in the packed record")
    print(f"# phase 17: {card}: bf16 {BATCH * TIMED_ITERS / sum(times):.2f} "
          f"scenes/s (batch {BATCH}, {TIMED_ITERS} timed batches "
          f"{[round(x * 1e3, 1) for x in times]} ms, warm-up "
          f"{warm * 1e3:.1f} ms); detections {int(keep.sum())}, n_live "
          f"{int(outs[-1]['n_live'])}, max spilled {spilled}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    _profile(lambda: fn(bufs[1]), 1e3 * sum(times) / len(times),
             "phase 17 profile (bf16)", "batch")

    # one scene: the GPU's kernels against the CPU's plain bf16 versions
    t1 = time.perf_counter()
    scene = bufs[0][:1].contiguous()
    gpu = {k: v.cpu() for k, v in fn(scene).items()}
    cpu_model = build_model(cfg, device="cpu")
    load_npz(cpu_model, WEIGHTS)
    cpu = make_two_stage_fn(cpu_model, cfg)(scene.cpu())
    _check_detections(gpu, cpu, float(cfg.IOUN.SCORE_THRESH))
    print(f"# phase 17: one scene GPU vs CPU plain, bf16: "
          f"{int(gpu['keep'].sum())} vs {int(cpu['keep'].sum())} detections "
          f"agree ({time.perf_counter() - t1:.1f} s)", flush=True)
    del fn, model, cpu_model, bufs, outs

    # eval_auto in f32 and in bf16, then the detection diff
    t1 = time.perf_counter()
    quiet = logging.getLogger("chip_smoke.bf16.quiet")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    src = SyntheticKitti(num_scenes=EVAL_SCENES, points_per_scene=20000,
                         seed=3)
    dets, aps, secs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for dtype in ("float32", "bfloat16"):
            cfg.TPU.COMPUTE_DTYPE = dtype
            model = build_model(cfg)
            load_npz(model, WEIGHTS)
            stats = {}
            ret = run_eval(model, cfg, src, RPNDataset(src, cfg, mode="EVAL",
                                                       seed=0),
                           quiet, scenes=EVAL_SCENES, batch=BATCH,
                           output_dir=os.path.join(tmp, dtype), stats=stats)
            dets[dtype] = stats["detections"]
            secs[dtype] = stats["seconds"]["inference"]
            aps[dtype] = " / ".join(f"{ret[f'Car_3d_{d}']:.4f}"
                                    for d in ("easy", "moderate", "hard"))
            del model
        rec_diff = diff(*(os.path.join(tmp, d, "final_result", "data")
                          for d in ("bfloat16", "float32")))
    print(f"# phase 17: {card}: eval_auto on {EVAL_SCENES} scenes: f32 "
          f"{dets['float32']} detections, Car 3D AP e/m/h "
          f"{aps['float32']}, inference {secs['float32']:.3f} s; bf16 "
          f"{dets['bfloat16']} detections, {aps['bfloat16']}, inference "
          f"{secs['bfloat16']:.3f} s ({time.perf_counter() - t1:.1f} s)",
          flush=True)
    # bounds: at most 4 detections unmatched (either side), and the
    # matched ones within 0.05 m (centre, dims) and 0.02 (score) on average
    print(f"# phase 17: diff_detections bf16 vs f32: {json.dumps(rec_diff)}"
          f" (bounds: only_a + only_b <= 4; mean centre, dims <= 0.05 m; "
          f"mean score <= 0.02)", flush=True)
    if not (rec_diff["matched"] > 0
            and rec_diff["only_a"] + rec_diff["only_b"] <= 4
            and rec_diff["center_m"]["mean"] <= 0.05
            and rec_diff["dims_m"]["mean"] <= 0.05
            and rec_diff["score"]["mean"] <= 0.02):
        raise AssertionError(f"bf16 vs f32 detections: {rec_diff}")
    return {"inference_bf16": launches, "fused_sa_idx_bf16_entry": entry}


ACTIVE_SCENES = 16         # tools/eval_active.py's defaults
ACTIVE_BATCH = 8
ACTIVE_MAX_POINTS = 16384
ACTIVE_KERNELS = ("crop_gather", "fps", "fused_sa_window", "fused_sa_full")
SEG_POINTS = 4096           # tools/pointnet2_seg.py's defaults
SEG_BATCH = 4
SEG_STEPS = 5
SEG_KERNELS = ("fps", "ball_query", "three_interpolate", "three_nn")


def _active_phase(card, per_kernel) -> dict:
    """Phase 18: the click-seeded annotator (see the module docstring);
    returns the timed run's launch counts."""
    import logging
    import tempfile
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import SyntheticKitti
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.tools import eval_active
    from ws3d_tpu_torch.weights import load_npz

    t0 = time.perf_counter()
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    model = build_model(cfg)
    load_npz(model, WEIGHTS)
    src = SyntheticKitti(num_scenes=ACTIVE_SCENES, points_per_scene=20000,
                         seed=3)
    quiet = logging.getLogger("chip_smoke.eval_active.quiet")
    quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    log = logging.getLogger("chip_smoke.eval_active")
    log.setLevel(logging.INFO)
    log.propagate = False
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(_CommentFormatter())
    run = dict(scenes=ACTIVE_SCENES, batch=ACTIVE_BATCH,
               max_points=ACTIVE_MAX_POINTS, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        # the warm-up run, every kernel call recorded and held against its
        # plain version (kernel 5 in its `s % cnt` mode on unsorted scenes)
        with Recorder() as rec:
            eval_active.run_active(model, cfg, src, quiet,
                                   output_dir=os.path.join(tmp, "warm"),
                                   no_ap=True, **run)
            torch.cuda.synchronize()
        print(f"# phase 18: {card}: eval_active warm-up run in "
              f"{time.perf_counter() - t0:.1f} s; {len(rec.calls)} kernel "
              f"calls", flush=True)
        modes = {kw.get("grouped", a[5] if len(a) > 5 else True)
                 for n, a, kw in rec.calls if n == "crop_gather_cuda"}
        if modes != {False}:
            raise AssertionError(f"eval_active crop modes {modes}: the "
                                 f"unsorted scenes need `s % cnt`")
        _compare_aside(rec.calls, per_kernel, "eval_active")
        del rec
        stats = {}
        log.addHandler(handler)
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        try:
            ret = eval_active.run_active(
                model, cfg, src, log, output_dir=os.path.join(tmp, "gpu"),
                stats=stats, **run)
            torch.cuda.synchronize()
        finally:
            log.removeHandler(handler)
        launches = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        sec = stats["seconds"]
        _profile(lambda: eval_active.run_active(
            model, cfg, src, quiet, output_dir=os.path.join(tmp, "prof"),
            no_ap=True, **run), 1e3 * sum(sec.values()),
            "phase 18 profile", "run of the 16 scenes (loading included)")
    missing = [k for k in ACTIVE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"eval_active launched no {missing}")
    if stats["detections"] == 0:
        raise AssertionError("eval_active: no detection")
    print(f"# phase 18: {card}: eval_active on {stats['scenes']} scenes "
          f"({stats['with_clicks']} with clicks) at batch {ACTIVE_BATCH}: "
          f"device+transfer {sec['device']:.4f} s = "
          f"{stats['scenes'] / sec['device']:.2f} scenes/s, host txt and "
          f"tally {sec['host']:.4f} s, loading {sec['load']:.3f} s; batches "
          f"(hypotheses, live slots, V) {stats['batches']}; detections "
          f"{stats['detections']}; Car 3D AP e/m/h "
          f"{ret['Car_3d_easy']:.4f} / {ret['Car_3d_moderate']:.4f} / "
          f"{ret['Car_3d_hard']:.4f}; peak memory {peak:.2f} GiB; "
          f"launches {launches}", flush=True)

    # finalize at the largest slot bucket, K 1,024 a scene, batch 8: the
    # (B, K, K) rotated IoU and the greedy sweep of K steps
    from ws3d_tpu_torch.pipeline.inference import finalize_detections
    g = torch.Generator(device="cpu").manual_seed(0)
    K = eval_active.SLOT_BUCKETS[-1]
    ctr = torch.rand(ACTIVE_BATCH, K, 2, generator=g) * 40.0
    boxes = torch.cat([torch.randn(ACTIVE_BATCH, K, 3, generator=g) * 0.3,
                       torch.tensor([1.5, 1.6, 3.9]).expand(ACTIVE_BATCH, K,
                                                            3),
                       torch.rand(ACTIVE_BATCH, K, 1, generator=g) * 6.0],
                      -1).cuda()
    cls = torch.randn(ACTIVE_BATCH, K, generator=g).cuda()
    iou = torch.rand(ACTIVE_BATCH, K, generator=g).cuda()
    live = torch.ones(ACTIVE_BATCH, K, dtype=torch.bool).cuda()
    ctr = ctr.cuda()
    finalize_detections(boxes, cls, iou, ctr, live, size_gate=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t1 = time.perf_counter()
    kept = finalize_detections(boxes, cls, iou, ctr, live,
                               size_gate=False)[2]
    torch.cuda.synchronize()
    print(f"# phase 18: finalize_detections at batch {ACTIVE_BATCH}, K {K}: "
          f"{1e3 * (time.perf_counter() - t1):.1f} ms, "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB "
          f"above its inputs, {int(kept.sum())} kept", flush=True)

    # one scene on the GPU and on the CPU (the plain versions)
    t1 = time.perf_counter()
    scene = src.get_scene(src.sample_ids[0], with_noise=True)
    pts, sc, hyp, valid = eval_active.scene_entry(
        scene, cfg, ACTIVE_MAX_POINTS, 0)
    V = eval_active.pick_v_bucket(int(valid.sum()), valid.size)
    cpu_model = build_model(cfg, device="cpu")
    load_npz(cpu_model, WEIGHTS)
    outs = []
    for m in (model, cpu_model):
        dev = next(m.parameters()).device
        packed, _ = eval_active.infer_batch(
            m, cfg, *(torch.from_numpy(a[None]).to(dev)
                      for a in (pts, sc, hyp, valid)), V)
        outs.append(packed.cpu())
    keep = [o[0, :, 8] > 0.5 for o in outs]
    if not torch.equal(keep[0], keep[1]):
        raise AssertionError("eval_active one scene: GPU and CPU keep "
                             "different hypotheses")
    err = float((outs[0][0, keep[0], 0:8] - outs[1][0, keep[0], 0:8]).abs()
                .max()) if bool(keep[0].any()) else 0.0
    if not err <= 1e-3:
        raise AssertionError(f"eval_active one scene: kept boxes differ by "
                             f"{err}")
    print(f"# phase 18: one scene GPU vs CPU plain: equal keep masks "
          f"({int(keep[0].sum())} of {int(valid.sum())} hypotheses), kept "
          f"boxes and scores within {err:.3g} "
          f"({time.perf_counter() - t1:.1f} s)", flush=True)
    return launches


def _flags_phase(card, per_kernel) -> dict:
    """Phase 19: one inference batch with RPN.USE_INTENSITY=False and
    ATTENTION=True from seeded weights; returns its launch counts."""
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.pipeline import make_two_stage_fn

    t0 = time.perf_counter()
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    cfg.RPN.USE_INTENSITY = False
    cfg.ATTENTION = True
    model = build_model(cfg, seed=0)
    fn = make_two_stage_fn(model, cfg)
    src = SyntheticKitti(num_scenes=BATCH, points_per_scene=20000, seed=3)
    ds = RPNDataset(src, cfg, mode="EVAL", npoints=cfg.RPN.NUM_POINTS,
                    seed=0)
    pts = torch.from_numpy(next(ds.batches(batch_size=BATCH, steps=1))[
        "pts_input"]).cuda()
    if pts.shape[-1] != 3:
        raise AssertionError(f"no-intensity input has {pts.shape[-1]} "
                             f"channels")
    with Recorder() as rec:
        fn(pts)
        torch.cuda.synchronize()
    _compare_aside(rec.calls, per_kernel, "no_intensity_attention")
    if not any(n == "ball_query_multi_cuda" for n, _, _ in rec.calls):
        raise AssertionError("the no-intensity SA0 did not reach kernel 6")
    del rec
    _kernels.reset_launch_counts()
    t1 = time.perf_counter()
    out = fn(pts)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1)
    launches = dict(_kernels.LAUNCHES)
    missing = [k for k in INFERENCE_KERNELS + ("ball_query",)
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"the no-intensity batch launched no {missing}")
    packed = out["packed"]
    if tuple(packed.shape) != (BATCH, cfg.TPU.MAX_PROPOSALS, 9) or not bool(
            torch.isfinite(packed[..., 0:7]).all()):
        raise AssertionError("non-finite or misshaped no-intensity record")
    print(f"# phase 19: {card}: USE_INTENSITY=False, ATTENTION=True, seeded "
          f"weights: one batch of {BATCH} in {ms:.1f} ms (after one "
          f"recorded batch; {time.perf_counter() - t0:.1f} s in all); "
          f"detections {int(out['keep'].sum())}, n_live "
          f"{int(out['n_live'])}; launches {launches}", flush=True)
    return launches


def _seg_phase(card, per_kernel) -> dict:
    """Phase 20: pointnet2_seg at its defaults; returns the launch counts
    of the timed steps."""
    import math as _math
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models.detector import init_random
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.tools import pointnet2_seg as seg

    t0 = time.perf_counter()
    cfg = load_config()
    seg.configure(cfg, SEG_POINTS)
    src = SyntheticKitti(num_scenes=16, points_per_scene=18000, seed=0)
    ds = RPNDataset(src, cfg, mode="EVAL", npoints=SEG_POINTS, seed=0)
    batches = [(torch.from_numpy(b["pts_input"]).cuda(),
                torch.from_numpy(b["label"]).cuda())
               for _, b in zip(range(SEG_STEPS + 2),
                               seg.seg_batches(ds, SEG_BATCH))]
    net = init_random(seg.SegNet(cfg), 0).cuda()
    opt = seg.make_optimizer(net, 0.002)
    with Recorder() as rec:
        seg.train_step(net, opt, *batches[0])
        torch.cuda.synchronize()
    _compare_aside(rec.calls, per_kernel, "pointnet2_seg")
    del rec
    seg.train_step(net, opt, *batches[1])
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t1 = time.perf_counter()
    losses = [seg.train_step(net, opt, *b) for b in batches[2:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = dict(_kernels.LAUNCHES)
    losses = [float(v) for v in losses]
    if not all(_math.isfinite(v) for v in losses):
        raise AssertionError(f"pointnet2_seg losses {losses}")
    missing = [k for k in SEG_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"pointnet2_seg launched no {missing}")
    print(f"# phase 20: {card}: pointnet2_seg at {SEG_POINTS} points, batch "
          f"{SEG_BATCH}: {SEG_STEPS / dt:.3f} steps/s over {SEG_STEPS} steps "
          f"(after two; {time.perf_counter() - t0:.1f} s in all); dice losses "
          f"{[round(v, 5) for v in losses]}; launches {launches}",
          flush=True)
    return launches


def _selftest_phase(card) -> None:
    """Phase 21: ws3d_tpu_torch.tools.gpu_selftest."""
    from ws3d_tpu_torch.tools import gpu_selftest
    t0 = time.perf_counter()
    failures = gpu_selftest.run()
    if failures:
        raise AssertionError(f"gpu_selftest: {failures} kernels failed")
    print(f"# phase 21: {card}: gpu_selftest passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic algorithms around phase 22's parity checks:
    index_add_ and the gather backward sum without atomics, so two runs of
    one step from one state agree bitwise. Without them two plain stage-1
    Trainers from the same state and batches differ after 4 steps (by
    2.4e-4 on an H100; phase 22 prints it): the atomics' order moves a
    near-zero gradient's sign, which Adam's first step turns into a whole
    lr. cuBLAS needs its workspace setting for
    that mode (set before phase 22 starts its ranks)."""
    import torch
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _quiet_log():
    import logging
    quiet = logging.getLogger("chip_smoke.quiet")
    if not quiet.handlers:
        quiet.addHandler(logging.NullHandler())
    quiet.propagate = False
    return quiet


def _eval_cfg():
    from ws3d_tpu_torch.config import load_config
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    return cfg


def _eval_inputs(device):
    """Phase 15's configuration, the fitted model on `device` and its 16
    EVAL scenes: (cfg, model, src, ds)."""
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.weights import load_npz
    cfg = _eval_cfg()
    model = build_model(cfg, device=device)
    load_npz(model, WEIGHTS)
    src = SyntheticKitti(num_scenes=EVAL_SCENES, points_per_scene=20000,
                         seed=3)
    return cfg, model, src, RPNDataset(src, cfg, mode="EVAL", seed=0)


def _timed_trainer(trainer, host, batches) -> list:
    """A warm-up step through train_steps on host[0], then one timed step
    a device batch; returns the steps' ms."""
    import torch
    trainer.train_steps([host[0]], total_steps=1, log_every=1,
                        prefetch_size=0)
    torch.cuda.synchronize()
    times = []
    for b in batches:
        t0 = time.perf_counter()
        trainer.step_fn(b, trainer.generator, trainer.bn_sched(0))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _world1_rank(group, host, out_dir) -> dict:
    """Phase 22 (a), the one rank of an NCCL group: the data-parallel
    stage-1 Trainer on phase 6's batches, then run_eval on phase 15's
    scenes (a warm-up run, then a timed one into `out_dir`)."""
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.parallel.dryrun import cpu_state
    from ws3d_tpu_torch.tools.eval_auto import run_eval
    from ws3d_tpu_torch.training import Trainer
    from ws3d_tpu_torch.training.trainer import batch_to_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config()
    model = _rpn_model(cfg, group.device)
    trainer = Trainer(model, cfg, total_steps=1000, seed=0, group=group,
                      log_fn=lambda msg: None)
    batches = [batch_to_device(b, group.device) for b in host[1:]]
    _kernels.reset_launch_counts()
    with _deterministic():
        times = _timed_trainer(trainer, host, batches)
    out = {"train_launches": dict(_kernels.LAUNCHES), "train_ms": times,
           "state": cpu_state(model), "step": trainer.step}
    cfg, model, src, ds = _eval_inputs(group.device)
    run_eval(model, cfg, src, ds, _quiet_log(), scenes=EVAL_SCENES,
             batch=BATCH, output_dir=os.path.join(out_dir, "warm"),
             no_ap=True, group=group)
    torch.cuda.synchronize()
    stats = {}
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run_eval(model, cfg, src, ds, _quiet_log(), scenes=EVAL_SCENES,
             batch=BATCH, output_dir=os.path.join(out_dir, "mesh1"),
             group=group, stats=stats)
    torch.cuda.synchronize()
    out.update(eval_s=time.perf_counter() - t0,
               eval_launches=dict(_kernels.LAUNCHES),
               detections=stats["detections"], seconds=stats["seconds"])
    return out


def _one_dp_step(cfg, stage, model, batch, group, timed: int = 0):
    """(state after one step on `batch`, its loss, ms of `timed` more
    steps): parallel.dryrun.one_step, single-process (group None) or data
    parallel on the rank's shard, from `model`'s weights."""
    import torch
    from ws3d_tpu_torch.parallel.dryrun import one_step
    state, aux, _, again = one_step(cfg, stage, model, batch, group)
    times = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return state, aux["loss"], times


def _shared_card_models(stage: str, device):
    if stage == "rpn":
        from ws3d_tpu_torch.config import load_config
        cfg = load_config()
        cfg.RPN.DP_RATIO = 0.0          # no dropout: exact parity
        return cfg, _rpn_model(cfg, device)
    cfg = _stage2_cfg(stage)
    return cfg, _stage2_model(cfg, device)


def _shared_card_rank(group, rpn_host, ioun_host, pts) -> dict:
    """Phase 22 (b), one of two gloo ranks on cuda:0: the stage-1 and IOUN
    steps on identical shards and on the whole batch, then the inference
    batch data parallel."""
    import numpy as np
    import torch
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.parallel import data_parallel_infer
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for stage, host in (("rpn", rpn_host), ("ioun", ioun_host)):
        per = len(next(iter(host.values()))) // group.world_size
        tiled = {k: np.concatenate([v[:per]] * group.world_size)
                 for k, v in host.items()}
        with _deterministic():
            cfg, model = _shared_card_models(stage, group.device)
            tiled_state = _one_dp_step(cfg, stage, model, tiled, group)[0]
            cfg, model = _shared_card_models(stage, group.device)
            _kernels.reset_launch_counts()
            state, loss, times = _one_dp_step(cfg, stage, model, host, group,
                                              timed=TIMED_ITERS)
        out[stage] = {"tiled": tiled_state, "full": state, "loss": loss,
                      "ms": times, "launches": dict(_kernels.LAUNCHES)}
        del model
        torch.cuda.empty_cache()
    cfg, model, _, _ = _eval_inputs(group.device)
    infer = data_parallel_infer(make_two_stage_fn(model, cfg, group=group),
                                group)
    batch = torch.from_numpy(pts)
    infer(batch)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    times = []
    for _ in range(TIMED_ITERS):
        t0 = time.perf_counter()
        got = infer(batch)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out["infer"] = {"out": {k: v.cpu() for k, v in got.items()},
                    "ms": times, "launches": dict(_kernels.LAUNCHES)}
    return out


def _kept_diff(a: dict, b: dict) -> float:
    """max |a - b| over the packed rows of the kept slots (the
    detections), which must be the same slots."""
    import torch
    keep = a["keep"].cpu()
    if not torch.equal(keep, b["keep"].cpu()) or not keep.any():
        raise AssertionError(f"the kept slots differ, or none: "
                             f"{int(keep.sum())} vs {int(b['keep'].sum())}")
    return float((a["packed"].cpu()[keep] - b["packed"].cpu()[keep]
                  ).abs().max())


def _scaleout_phase(card, phase6_ms: float) -> dict:
    """Phase 22 (see the module docstring); returns the launch counts of
    its data-parallel paths."""
    import tempfile
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.parallel import launch
    from ws3d_tpu_torch.parallel.dryrun import cpu_state, max_diff
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    from ws3d_tpu_torch.tools.diff_detections import load_txt
    from ws3d_tpu_torch.tools.eval_auto import run_eval
    from ws3d_tpu_torch.training import Trainer
    from ws3d_tpu_torch.training.trainer import (batch_to_device,
                                                 trainable_parameters)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # ranks too
    cfg = load_config()
    src = SyntheticKitti(num_scenes=BATCH * 2, points_per_scene=20000, seed=3)
    host = list(RPNDataset(src, cfg, mode="TRAIN", seed=0).batches(
        BATCH, steps=1 + SCALEOUT_STEPS, shuffle=True))
    launches = {}

    # ---- (a) NCCL at world size 1
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        w1 = launch(_world1_rank, 1, host, tmp, device="cuda",
                    timeout=600)[0]
        t_launch = time.perf_counter() - t0
        model = _rpn_model(cfg, "cuda")
        trainer = Trainer(model, cfg, total_steps=1000, seed=0,
                          log_fn=lambda msg: None)
        with _deterministic():
            plain_ms = _timed_trainer(trainer, host, [
                batch_to_device(b, "cuda") for b in host[1:]])
        err = max_diff(w1["state"], cpu_state(model))
        if w1["step"] != trainer.step or not err <= 1e-5:
            raise AssertionError(f"world-1 Trainer vs the plain one: steps "
                                 f"{w1['step']} vs {trainer.step}, max|diff| "
                                 f"{err}")
        missing = [k for k in TRAIN_KERNELS if not w1["train_launches"][k]]
        if missing:
            raise AssertionError(f"world-1 Trainer launched no {missing}")
        dp_ms = sum(w1["train_ms"]) / len(w1["train_ms"])
        print(f"# phase 22: {card}: NCCL world 1 Trainer (deterministic "
              f"algorithms, as the plain one beside it) {1e3 / dp_ms:.3f} "
              f"steps/s ({[round(t, 1) for t in w1['train_ms']]} ms), the "
              f"plain Trainer {1e3 * len(plain_ms) / sum(plain_ms):.3f} "
              f"({[round(t, 1) for t in plain_ms]} ms), phase 6 "
              f"{1e3 / phase6_ms:.3f}; params and BN statistics max|diff| "
              f"{err:.3g} after {trainer.step} steps; the rank started and "
              f"ran in {t_launch:.1f} s; launches {w1['train_launches']}",
              flush=True)
        del model, trainer
        ecfg, emodel, esrc, eds = _eval_inputs("cuda")
        run_eval(emodel, ecfg, esrc, eds, _quiet_log(), scenes=EVAL_SCENES,
                 batch=BATCH, output_dir=os.path.join(tmp, "single"),
                 no_ap=True)
        data = [os.path.join(tmp, side, "final_result", "data")
                for side in ("single", "mesh1")]
        names = sorted(os.listdir(data[0]))
        if names != sorted(os.listdir(data[1])):
            raise AssertionError("eval_auto --mesh 1 wrote other files")
        n_det = 0
        for name in names:
            a, b = (load_txt(os.path.join(d, name)) for d in data)
            if len(a) != len(b):
                raise AssertionError(f"{name}: {len(a)} vs {len(b)} "
                                     f"detections")
            _check_txt(a, b, float(ecfg.IOUN.SCORE_THRESH))
            n_det += len(a)
        missing = [k for k in INFERENCE_KERNELS
                   if not w1["eval_launches"][k]]
        if missing or n_det != w1["detections"] or n_det == 0:
            raise AssertionError(f"eval_auto --mesh 1: {w1['detections']} "
                                 f"detections, {n_det} single; launched no "
                                 f"{missing}")
        print(f"# phase 22: {card}: eval_auto --mesh 1 (NCCL) on "
              f"{EVAL_SCENES} scenes: {n_det} detections, the single run's "
              f"within 1e-3; {w1['eval_s']:.3f} s (inference "
              f"{w1['seconds']['inference']:.3f}); launches "
              f"{w1['eval_launches']}", flush=True)
        del emodel
    launches["scaleout_train_nccl1"] = w1["train_launches"]
    launches["scaleout_eval_nccl1"] = w1["eval_launches"]

    # ---- (b) two gloo ranks sharing cuda:0, CUDA tensors
    torch.cuda.empty_cache()
    rpn_host = {k: host[0][k] for k in ("pts_input", "rpn_cls_label",
                                        "rpn_reg_label")}
    icfg = _stage2_cfg("ioun")
    ioun_host = _stage2_batches(icfg, 1)[0]
    eds = RPNDataset(SyntheticKitti(num_scenes=BATCH * 2,
                                    points_per_scene=20000, seed=3),
                     _eval_cfg(), mode="EVAL", seed=0)
    pts = next(eds.batches(batch_size=BATCH, steps=1))["pts_input"]
    t0 = time.perf_counter()
    ranks = launch(_shared_card_rank, 2, rpn_host, ioun_host, pts,
                   backend="gloo", device="cuda:0", timeout=900)
    t_launch = time.perf_counter() - t0
    notes = []
    kernels = {"rpn": TRAIN_KERNELS, "ioun": tuple(STAGE2_STEP_LAUNCHES["ioun"])}
    for stage, host_batch, bound in (("rpn", rpn_host, 0.05),
                                     ("ioun", ioun_host, 0.15)):
        per = len(next(iter(host_batch.values()))) // 2
        with _deterministic():
            cfg_s, model = _shared_card_models(stage, "cuda")
            ref_state = _one_dp_step(
                cfg_s, stage, model,
                {k: v[:per] for k, v in host_batch.items()}, None)[0]
            cfg_s, model = _shared_card_models(stage, "cuda")
            _, ref_loss, ref_ms = _one_dp_step(cfg_s, stage, model,
                                               host_batch, None,
                                               timed=TIMED_ITERS)
        r0, r1 = ranks[0][stage], ranks[1][stage]
        exact = max_diff(r0["tiled"], ref_state)
        rel = abs(r0["loss"] - ref_loss) / abs(ref_loss)
        if not exact < 1e-5:
            raise AssertionError(f"{stage}: identical shards vs the single "
                                 f"step: max|diff| {exact}")
        if not (math.isfinite(r0["loss"]) and rel < bound):
            raise AssertionError(f"{stage}: loss {r0['loss']} vs the whole "
                                 f"batch's {ref_loss}")
        for key in ("tiled", "full"):
            if max_diff(r0[key], r1[key]) != 0.0:
                raise AssertionError(f"{stage}: the replicas differ ({key})")
        if stage == "ioun":
            model = _shared_card_models(stage, "cuda")[1]
            trained = set(trainable_parameters(model, stage))
            init = cpu_state(model)
            moved = [k for k in init if k not in trained
                     and not torch.equal(init[k], r0["full"][k])]
            if moved:
                raise AssertionError(f"the frozen trunk moved: {moved[:3]}")
        for r, res in enumerate((r0, r1)):
            missing = [k for k in kernels[stage] if not res["launches"][k]]
            if missing:
                raise AssertionError(f"{stage} rank {r} launched no "
                                     f"{missing}")
        launches[f"scaleout_{stage}_gloo2"] = {
            k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
        notes.append(f"{stage}: identical shards max|diff| {exact:.3g}, "
                     f"loss {r0['loss']:.5f} vs {ref_loss:.5f} (rel "
                     f"{rel:.3g}), replicas bit-equal; a step "
                     f"{[round(t, 1) for t in r0['ms']]} ms on two ranks, "
                     f"{[round(t, 1) for t in ref_ms]} ms alone")
        del model
        torch.cuda.empty_cache()
    cfg_e, model, _, _ = _eval_inputs("cuda")
    ref = make_two_stage_fn(model, cfg_e)(torch.from_numpy(pts).cuda())
    r0, r1 = ranks[0]["infer"], ranks[1]["infer"]
    got = r0["out"]
    for k in got:
        if not torch.equal(got[k], r1["out"][k]):
            raise AssertionError(f"the ranks gathered another {k}")
    err = _kept_diff(got, ref)
    keeps = (got["keep"].sum(-1), ref["keep"].cpu().sum(-1))
    spilled = [int(got["spilled"]), int(ref["spilled"])]
    live = [int(got["n_live"]), int(ref["n_live"])]
    if not (err < 1e-3 and torch.equal(*keeps) and live[0] == live[1]
            and not any(spilled)):
        raise AssertionError(f"inference over two ranks: packed max|diff| "
                             f"{err}, keep counts {keeps}, n_live {live}, "
                             f"spilled {spilled}")
    for r, res in enumerate((r0, r1)):
        missing = [k for k in INFERENCE_KERNELS if not res["launches"][k]]
        if missing:
            raise AssertionError(f"inference rank {r} launched no {missing}")
    launches["scaleout_infer_gloo2"] = {
        k: r0["launches"][k] + r1["launches"][k] for k in r0["launches"]}
    ms = sum(r0["ms"]) / len(r0["ms"])
    notes.append(f"inference: {int(keeps[0].sum())} detections, packed "
                 f"max|diff| {err:.3g} against the single batch, spilled 0; "
                 f"a batch of {BATCH} {[round(t, 1) for t in r0['ms']]} ms "
                 f"({BATCH * 1e3 / ms:.2f} scenes/s)")
    print(f"# phase 22: {card}: two gloo ranks sharing one card (CUDA "
          f"tensors; the steps with deterministic algorithms), not a "
          f"scaling figure; started and ran in "
          f"{t_launch:.1f} s: " + "; ".join(notes), flush=True)
    print(f"# phase 22: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


def _snapshot(trainer) -> list:
    """The trainer's generator state, then a copy of every parameter and
    buffer of its model."""
    return ([trainer.generator.get_state()]
            + [v.detach().clone() for v in trainer.model.state_dict().values()])


def _gated_val_fn(trainer, inner, rec, stats: dict):
    """val_fn for Trainer.train_steps: runs `inner`, the first time under
    the Recorder `rec`; times each call (device synchronised before and
    after), counts its launches, and requires the trainer's generator
    state and every parameter and buffer bit-equal before and after it."""
    import torch
    from ws3d_tpu_torch.ops import _kernels

    def val_fn(model):
        before = _snapshot(trainer)
        counts = dict(_kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not stats["seconds"]:
            with rec:
                metrics = inner(model)
        else:
            metrics = inner(model)
        torch.cuda.synchronize()
        stats["seconds"].append(time.perf_counter() - t0)
        stats["launches"] = {k: v - counts[k]
                             for k, v in _kernels.LAUNCHES.items()
                             if v - counts[k]}
        after = _snapshot(trainer)
        if not (len(before) == len(after)
                and all(torch.equal(a, b) for a, b in zip(before, after))):
            raise AssertionError(f"validation changed the {trainer.stage} "
                                 f"trainer's generator, weights or BN "
                                 f"statistics")
        return metrics
    return val_fn


def _train_loop(phase: str, trainer, host, total_steps: int, val_fn,
                val_stats, per_kernel, path: str, card) -> dict:
    """Trainer.train_steps over `host` with `val_fn` every VAL_EVERY steps
    into a temporary directory, then its gates (finite losses, a checkpoint
    per eval and the best one) and the validation forward's kernel calls
    against their plain versions; returns the loop's launch counts."""
    import tempfile
    import torch
    from ws3d_tpu_torch.ops import _kernels
    rec = Recorder()
    gated = _gated_val_fn(trainer, val_fn, rec, val_stats)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        hist = trainer.train_steps(host, total_steps=total_steps,
                                   log_every=1, prefetch_size=0,
                                   ckpt_dir=tmp, val_fn=gated,
                                   val_every=VAL_EVERY)
        torch.cuda.synchronize()
        loop = time.perf_counter() - t0
        launches = dict(_kernels.LAUNCHES)
        files = sorted(f for f in os.listdir(tmp)
                       if f.startswith(f"{trainer.stage}_ckpt_"))
    losses = [h["loss"] for h in hist]
    if len(losses) != total_steps or not all(math.isfinite(v)
                                             for v in losses):
        raise AssertionError(f"{phase}: losses {losses}")
    n_eval = len(val_stats["seconds"])
    want = [f"{trainer.stage}_ckpt_best.pt"] + [
        f"{trainer.stage}_ckpt_e{k}.pt" for k in range(1, n_eval + 1)]
    if n_eval == 0 or files != sorted(want):
        raise AssertionError(f"{phase}: checkpoints {files}, not {want}")
    val_s = sum(val_stats["seconds"])
    print(f"# phase 16: {card}: {phase}: {total_steps} steps and {n_eval} "
          f"evals in {loop:.3f} s; validation {val_s:.3f} s "
          f"({[round(v, 3) for v in val_stats['seconds']]}), "
          f"{100 * val_s / loop:.1f} % of the loop; best "
          f"{trainer.best_val}; losses {[round(v, 5) for v in losses]}; "
          f"one validation forward launches {val_stats['launches']}; the "
          f"loop's launches {({k: v for k, v in launches.items() if v})}; "
          f"{files}; generator, weights and "
          f"BN statistics bit-equal across every eval", flush=True)
    # the eval shapes' times stay out of the line's totals
    _compare_aside(rec.calls, per_kernel, path)
    names = {n for n, _, _ in rec.calls}
    print(f"# phase 16: {phase}: the {len(rec.calls)} kernel calls of one "
          f"validation forward ({sorted(names)}) held against their plain "
          f"versions", flush=True)
    return launches


def _host_profile(src, cfg, database) -> None:
    """cProfile of two augmented and two plain stage-1 TRAIN batches of
    BATCH scenes, built on the host as a run's loader builds them; prints
    each HOST_PROFILE function's cumulative (own) ms a batch."""
    import cProfile
    import pstats
    from ws3d_tpu_torch.datasets import RPNDataset
    parts = []
    for name, kw in (("augmented", {"gt_database": database}), ("plain", {})):
        ds = RPNDataset(src, cfg, mode="TRAIN", seed=2, **kw)
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        list(ds.batches(BATCH, steps=2, shuffle=True))
        prof.disable()
        wall = (time.perf_counter() - t0) / 2
        times = {}
        for (_, _, fn), (_, _, own, cum, _) in pstats.Stats(
                prof).stats.items():
            if fn in HOST_PROFILE:
                own0, cum0 = times.get(fn, (0.0, 0.0))
                times[fn] = (own0 + own / 2, cum0 + cum / 2)
        parts.append(f"{name} {1e3 * wall:.1f} ms a batch: " + ", ".join(
            f"{fn} {1e3 * times[fn][1]:.1f} ({1e3 * times[fn][0]:.1f})"
            for fn in HOST_PROFILE if fn in times))
    print(f"# phase 16: host profile of a stage-1 TRAIN batch of {BATCH} "
          f"(cProfile, cumulative ms a batch, own ms in parentheses): "
          + "; ".join(parts), flush=True)


def _prefetch_loop(card, name: str, trainer, batches) -> None:
    """PREFETCH_STEPS steps of `trainer` on `batches`, built as the loop
    goes one batch ahead on the prefetch thread (Trainer.train_steps's
    default), prints the time between the loop's pulls of successive
    batches after the first (the step time the loop sustains)."""
    import torch
    from ws3d_tpu_torch.utils.prefetch import prefetch
    pulls = []

    def timed(it):
        for batch in it:
            pulls.append(time.perf_counter())
            yield batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = trainer.train_steps(timed(prefetch(batches, size=2)),
                               total_steps=PREFETCH_STEPS,
                               log_every=PREFETCH_STEPS, prefetch_size=0)
    torch.cuda.synchronize()
    loop = time.perf_counter() - t0
    if not all(math.isfinite(v) for h in hist for v in h.values()):
        raise AssertionError(f"prefetch loop ({name}): {hist}")
    gaps = [1e3 * (b - a) for a, b in zip(pulls[1:], pulls[2:])]
    print(f"# phase 16: {card}: stage-1 loop on {name} batches with the "
          f"loader prefetching: {sum(gaps) / len(gaps):.1f} ms a step "
          f"(between pulls after the first: {[round(g, 1) for g in gaps]} "
          f"ms); {PREFETCH_STEPS} steps in {loop:.3f} s, the first pull "
          f"{1e3 * (pulls[0] - t0):.1f} ms in", flush=True)


def _train_val_phase(card, per_kernel) -> dict:
    """Phase 16: stage-1 training with the GT-database augmentation and
    validation, then RCNN training with validation, both at full width;
    returns the two loops' launch counts."""
    import numpy as np
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import (BoxPlaceDataset, RPNDataset,
                                         SyntheticKitti,
                                         synthetic_proposal_database)
    from ws3d_tpu_torch.datasets import rpn_dataset
    from ws3d_tpu_torch.datasets.gt_database import build_gt_database
    from ws3d_tpu_torch.tools.train_cascade import split_database
    from ws3d_tpu_torch.training import Trainer, make_val_fn
    from ws3d_tpu_torch.training.trainer import batch_to_device

    launches = {}
    t0 = time.perf_counter()
    cfg = load_config()                       # stage 1, DP_RATIO 0.5
    src = SyntheticKitti(num_scenes=BATCH, points_per_scene=20000, seed=3)
    database = build_gt_database(src, src.sample_ids)
    t_db = time.perf_counter() - t0
    pasted = []
    aug = rpn_dataset.apply_gt_aug

    def counting_aug(*args, **kw):
        out = aug(*args, **kw)
        pasted.append(out[2].shape[0])
        return out
    rpn_dataset.apply_gt_aug = counting_aug
    try:
        t1 = time.perf_counter()
        ds = RPNDataset(src, cfg, mode="TRAIN", seed=0, gt_database=database)
        host = list(ds.batches(BATCH, steps=1 + RPN_VAL_STEPS, shuffle=True))
        t_aug = (time.perf_counter() - t1) / len(host)
    finally:
        rpn_dataset.apply_gt_aug = aug
    t1 = time.perf_counter()
    plain_host = list(RPNDataset(src, cfg, mode="TRAIN", seed=1).batches(
        BATCH, steps=2, shuffle=True))
    t_plain = (time.perf_counter() - t1) / len(plain_host)
    print(f"# phase 16: GT database of {BATCH} scenes: {len(database[0])} "
          f"easy and {len(database[1])} hard instances in {t_db:.2f} s; "
          f"{len(pasted)} augmented scenes, {np.mean(pasted):.2f} pasted "
          f"instances a scene (min {min(pasted)}, max {max(pasted)}); host "
          f"{1e3 * t_aug:.1f} ms a TRAIN batch of {BATCH} with the "
          f"augmentation, {1e3 * t_plain:.1f} ms without", flush=True)

    model = _rpn_model(cfg, "cuda")
    trainer = Trainer(model, cfg, total_steps=1000, seed=0,
                      log_fn=lambda msg: print("#   " + msg, flush=True))
    val_src = SyntheticKitti(num_scenes=VAL_SCENES, points_per_scene=18000,
                             seed=1000)
    val_ds = RPNDataset(val_src, cfg, mode="EVAL", seed=0)
    val_fn = make_val_fn(cfg, "rpn", lambda: val_ds.batches(VAL_SCENES))
    val_stats = {"seconds": []}
    launches["rpn_train_val"] = _train_loop(
        "stage 1 with the augmentation", trainer, host, 1 + RPN_VAL_STEPS,
        val_fn, val_stats, per_kernel, "rpn_val", card)
    for key in ("fps", "three_interpolate"):
        if not val_stats["launches"].get(key):
            raise AssertionError(f"the stage-1 validation forward launched "
                                 f"no {key}")

    # step time with and without the augmentation, in turns
    aug_b = [batch_to_device(b, "cuda") for b in host[-2:]]
    plain_b = [batch_to_device(b, "cuda") for b in plain_host]
    step_times = []
    for a, p in zip(aug_b, plain_b):
        for b in (a, p):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.step_fn(b, trainer.generator, trainer.bn_sched(0))
            torch.cuda.synchronize()
            step_times.append(time.perf_counter() - t1)
    t_a = 1e3 * np.mean(step_times[0::2])
    t_p = 1e3 * np.mean(step_times[1::2])
    print(f"# phase 16: {card}: stage-1 step {t_a:.1f} ms on augmented "
          f"batches, {t_p:.1f} ms on plain ones (two each, in turns: "
          f"{[round(1e3 * v, 1) for v in step_times]} ms)", flush=True)
    del aug_b, plain_b
    _host_profile(src, cfg, database)
    for name, kw in (("augmented", {"gt_database": database}), ("plain", {})):
        ds = RPNDataset(src, cfg, mode="TRAIN", seed=4, **kw)
        _prefetch_loop(card, name, trainer,
                       ds.batches(BATCH, steps=PREFETCH_STEPS, shuffle=True))
    del trainer, model
    torch.cuda.empty_cache()

    # RCNN with a held-out tenth of phase 8's database
    cfg = _stage2_cfg("rcnn")
    db = synthetic_proposal_database(num=STAGE2_BATCH // 2, seed=0,
                                     crop_points=STAGE2_POINTS)
    train_db, val_db = split_database(db, 0.1)
    host = list(BoxPlaceDataset(train_db, cfg, mode="TRAIN",
                                npoints=STAGE2_POINTS, seed=0).batches(
        STAGE2_BATCH, steps=1 + RCNN_VAL_STEPS))
    val_ds = BoxPlaceDataset(val_db, cfg, mode="EVAL", npoints=STAGE2_POINTS,
                             seed=0)
    val_fn = make_val_fn(cfg, "rcnn", lambda: val_ds.batches(
        len(val_ds), steps=1, shuffle=False))
    model = _stage2_model(cfg, "cuda")
    trainer = Trainer(model, cfg, total_steps=1000, stage="rcnn", seed=0,
                      log_fn=lambda msg: print("#   " + msg, flush=True))
    val_stats = {"seconds": []}
    print(f"# phase 16: RCNN: {len(train_db)} training and {len(val_db)} "
          f"held-out records", flush=True)
    launches["rcnn_train_val"] = _train_loop(
        "RCNN", trainer, host, 1 + RCNN_VAL_STEPS, val_fn, val_stats,
        per_kernel, "rcnn_val", card)
    for key in ("fps", "fused_sa_window", "fused_sa_full"):
        if not val_stats["launches"].get(key):
            raise AssertionError(f"the RCNN validation forward launched no "
                                 f"{key}")
    print(f"# phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


class _CommentFormatter:
    """Log records as comment lines ("#   " before each line)."""

    def format(self, record) -> str:
        return "\n".join("#   " + line
                         for line in record.getMessage().splitlines())


def _check_txt(a, b, score_thresh: float, tol: float = 1e-3) -> None:
    """_check_detections's rule on two result files' rows: every detection
    matched (the diff tool's match) within `tol` in centre and score, unless
    its score lies within 0.02 of the threshold."""
    import numpy as np
    from ws3d_tpu_torch.tools.diff_detections import match
    pairs = match(a, b)
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
