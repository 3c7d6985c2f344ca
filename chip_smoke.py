#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. build the CUDA kernels from ws3d_tpu_torch/csrc (nvcc, sm_90a);
  2. run the two-stage pipeline once on a batch of the main path (16
     scenes), record every kernel call it makes, and hold each kernel
     against its plain PyTorch version on the recorded inputs (indices
     exact, floats within the stated tolerance), with CUDA-event times, the
     plain version's time and a roofline bound;
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
     (kernel 7) against their plain versions on the recorded inputs
     (indices exact, d2 bit-exact), and the interpolation's backward
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
     stage, then drive its entry point fused_sa_single_scale on them; hold
     the FusedSA backward against autograd through the plain forward;
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
 12. print the kernel table, the card's name and power limit, and the
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 SIMT FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

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


# ---------------------------------------------------------------- recording
class Recorder:
    """Wraps each kernel wrapper to keep a copy of the inputs (`calls`) of
    every call the pipeline makes (phases 2, 5 and 8 replay them) and, with
    `outputs`, of its outputs (`outputs`)."""

    def __init__(self, outputs: bool = False):
        from ws3d_tpu_torch.ops import (ball_query, crop_gather, fused_sa,
                                        fused_sa_idx, interpolate, sampling)
        self.calls, self.outputs, self.keep_outputs = [], [], outputs
        self.targets = [(sampling, "fps_cuda"), (fused_sa, "fused_sa_cuda"),
                        (interpolate, "three_interpolate_cuda"),
                        (crop_gather, "crop_gather_cuda"),
                        (ball_query, "ball_query_multi_cuda"),
                        (interpolate, "three_nn_cuda"),
                        (fused_sa_idx, "fused_sa_idx_cuda")]
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
        scanned = _scanned_points(xyz, new_xyz, radius, nsample, window)
        nbytes = 4 * (B * P * 3 + B * P * C + B * M * 3 + B * M * widths[-1]
                      + sum(k.numel() + b.numel()
                            for k, b in zip(kernels, biases)))
        ops = mlp_ops + 9 * scanned
        return (key, err, ms, plain, nbytes, ops,
                f"B{B} P{P} M{M} C{C} S{nsample} {widths}")

    if name == "three_interpolate_cuda":
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
        ops = B * n * m * 10 + B * n * C * 5
        return ("three_interpolate", err, ms, plain, nbytes, ops,
                f"B{B} n{n} m{m} C{C}")

    if name == "crop_gather_cuda":
        vals, cnt = crop_gather.crop_gather_cuda(*args, **kw)
        rv, rc = crop_gather.crop_gather_plain(*args, **kw)
        if not torch.equal(cnt, rc):
            raise AssertionError("crop_gather counts differ")
        err = (vals - rv).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"crop_gather values differ by {err}")
        ms = cuda_ms(lambda: crop_gather.crop_gather_cuda(*args, **kw), 5)
        plain = cuda_ms(lambda: crop_gather.crop_gather_plain(*args, **kw), 1)
        xyz, ch, centers, _, k = args[:5]
        B, N, _ = xyz.shape
        Cc, M = ch.shape[1], centers.shape[1]
        nbytes = 4 * (B * N * 3 + B * Cc * N + B * M * 2 + Cc * B * M * k
                      + B * M)
        ops = B * M * N * 6
        return ("crop_gather", err, ms, plain, nbytes, ops,
                f"B{B} N{N} M{M} k{k}")

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
        ops = (8 + len(radii)) * _tested_points(radii, nsamples, xyz,
                                                new_xyz)
        return ("ball_query", 0.0, ms, plain, nbytes, ops,
                f"B{B} N{N} M{M} r{radii} S{nsamples}")

    if name == "three_nn_cuda":
        unknown, known = args
        d2, idx = interpolate.three_nn_cuda(*args)
        rd2, ridx = interpolate.three_nn_plain(*args)
        if not torch.equal(idx, ridx):
            bad = (idx != ridx).sum().item()
            raise AssertionError(f"three_nn {tuple(unknown.shape)}: {bad} "
                                 f"indices differ from the plain version")
        err = (d2 - rd2).abs().max().item()
        if err != 0.0:
            raise AssertionError(f"three_nn d2 differs by {err}")
        ms = cuda_ms(lambda: interpolate.three_nn_cuda(*args), 5)
        plain = cuda_ms(lambda: interpolate.three_nn_plain(*args), 1)
        B, n, _ = unknown.shape
        m = known.shape[1]
        nbytes = 4 * (B * n * 3 + B * m * 3 + B * n * 6)
        ops = B * n * m * 10
        return ("three_nn", err, ms, plain, nbytes, ops, f"B{B} n{n} m{m}")

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
        ops = 2 * B * M * S * sum(a * b for a, b in zip(widths[:-1],
                                                        widths[1:]))
        return ("fused_sa_idx", err, ms, plain, nbytes, ops,
                f"B{B} P{P} M{M} C{C} S{S} {widths}")
    raise KeyError(name)


def _tested_points(radii, nsamples, xyz, new_xyz) -> int:
    """Points the multi-scale ball query must test: per query, up to and
    including the S_i-th hit of the scale that fills last (all points when
    a scale does not fill)."""
    import torch
    from ws3d_tpu_torch.ops.grouping import pairwise_sqdist, radius_sq
    N = xyz.shape[1]
    total = 0
    for m0 in range(0, new_xyz.shape[1], 256):
        d2 = pairwise_sqdist(new_xyz[:, m0:m0 + 256], xyz)      # (B, m, N)
        reach = None
        for r, k in zip(radii, nsamples):
            cum = torch.cumsum(d2 < radius_sq(r, xyz.device), dim=-1)
            pos = torch.searchsorted(cum, torch.full_like(
                cum[..., :1], int(k)))[..., 0] + 1
            pos = torch.where(cum[..., -1] >= k, pos, N)
            reach = pos if reach is None else torch.maximum(reach, pos)
        total += int(reach.sum())
    return total


def _scanned_points(xyz, new_xyz, radius, nsample, window) -> int:
    """Points the ball query must test: per query, up to and including the
    S-th hit inside its scan range ([lo, hi) for the windowed entry)."""
    import torch
    from ws3d_tpu_torch.ops import fused_sa
    from ws3d_tpu_torch.ops.grouping import pairwise_sqdist, radius_sq
    B, P, _ = xyz.shape
    r2 = radius_sq(radius, xyz.device)
    win = radius * (1 + fused_sa._WINDOW_REL) + fused_sa._WINDOW_ABS
    total = 0
    pos = torch.arange(P, device=xyz.device)
    for m0 in range(0, new_xyz.shape[1], 256):
        q = new_xyz[:, m0:m0 + 256]
        inb = pairwise_sqdist(q, xyz) < r2                     # (B, m, P)
        if window:
            z = xyz[..., 2].double().contiguous()
            qz = q[..., 2].double().contiguous()
            lo = torch.searchsorted(z, qz - win, side="left")
            hi = torch.searchsorted(z, qz + win, side="right")
        else:
            lo = torch.zeros(q.shape[:2], dtype=torch.long, device=q.device)
            hi = torch.full_like(lo, P)
        inr = (pos >= lo[..., None]) & (pos < hi[..., None])
        cum = torch.cumsum(inb & inr, dim=-1)
        reach = torch.where(cum[..., -1] >= nsample,
                            torch.searchsorted(cum, torch.full_like(
                                lo[..., None], nsample))[..., 0] + 1, hi)
        total += int((reach - lo).clamp(min=0).sum())
    return total


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
    log = lib_path.parent / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("#   " + line.strip())

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
    per_kernel = {k: {"err": 0.0, "ms": 0.0, "plain": 0.0, "bound": 0.0,
                      "by_bytes": 0.0, "ms_by_path": {}} for k in KERNELS}
    _compare_calls(rec.calls, per_kernel, "inference")
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
    del model, fn, cpu_model, bufs

    # ---- 5.-7. the stage-1 training path
    launches["train"] = _train_phases(card, per_kernel)

    # ---- 8.-11. the stage-2 (RCNN, IOUN) training paths
    launches.update(_stage2_phases(card, per_kernel))

    # ---- 12. report
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


def _compare_calls(calls, per_kernel, path: str) -> None:
    """Replay recorded kernel calls of `path` against their plain versions
    and add each call's error, times and bound to `per_kernel`."""
    import torch
    with torch.no_grad():
        for name, args, kw in calls:
            key, err, ms, plain, nbytes, ops, note = compare_call(name, args,
                                                                  kw)
            t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
            agg = per_kernel[key]
            agg["err"] = max(agg["err"], err)
            agg["ms"] += ms
            agg["ms_by_path"][path] = agg["ms_by_path"].get(path, 0.0) + ms
            agg["plain"] += plain
            agg["bound"] += max(t_bytes, t_ops)
            agg["by_bytes"] += t_bytes if t_bytes >= t_ops else 0.0
            print(f"#   {key:17s} {note:44s} err {err:.3g} kernel {ms:.4f} ms"
                  f" plain {plain:.3f} ms bound {max(t_bytes, t_ops):.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'})",
                  flush=True)


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
    _compare_calls(calls, per_kernel, "train")
    for key in ("ball_query", "three_nn"):
        if per_kernel[key]["ms"] == 0.0:
            raise AssertionError(f"kernel {key} was never called in a step")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, args, _ in rec.calls:
        if name != "three_interpolate_cuda":
            continue
        unknown, known, feats = args
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
        tol = 1e-4 * fo.abs().max().item()
        print(f"#   fused_sa_idx on kernel 6's indices vs the fused kernel "
              f"(window={window}) S{nsample}: max|diff| {err:.3g} "
              f"(tol {tol:.3g})", flush=True)
        if not err <= tol:
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
        run()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(r[1] for r in rows)
    print(f"# {label}: {busy:.1f} ms of kernels in one {unit}, "
          f"{100 * busy / ms:.1f} % of the {ms:.1f} ms {unit} "
          f"({len(rows)} kernel names)")
    ours = ("fps_kernel", "fused_sa_kernel", "three_interp_kernel",
            "crop_gather_kernel", "ball_query_kernel", "three_nn_kernel")
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
