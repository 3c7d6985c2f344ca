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
  3. the main path: 16 synthetic scenes at full width with the fitted
     weights (ws3d_tpu/data/bench_weights.npz) through make_two_stage_fn,
     one warm-up and timed batches closed by torch.cuda.synchronize();
     every kernel's launch count must rise during this run;
  4. one scene through the port on the GPU and on the CPU (the plain
     versions); the detections must agree;
  5. print the kernel table, the card's name and power limit, and the
     result line.

Prints nothing of the result and exits 2 without a CUDA device or outside
a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WEIGHTS = os.path.join(ROOT, "ws3d_tpu", "data", "bench_weights.npz")
BATCH = 16
TIMED_ITERS = 3

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
}


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
    """Wraps each kernel wrapper to keep a copy of the inputs of every call
    the pipeline makes (phase 2 replays them)."""

    def __init__(self):
        from ws3d_tpu_torch.ops import (crop_gather, fused_sa, interpolate,
                                        sampling)
        self.calls = []
        self.targets = [(sampling, "fps_cuda"), (fused_sa, "fused_sa_cuda"),
                        (interpolate, "three_interpolate_cuda"),
                        (crop_gather, "crop_gather_cuda")]
        self.saved = {}

    def __enter__(self):
        import torch
        for mod, name in self.targets:
            orig = getattr(mod, name)
            self.saved[(mod, name)] = orig

            def wrapped(*args, _orig=orig, _name=name, **kw):
                keep = [a.clone() if isinstance(a, torch.Tensor) else
                        [t.clone() for t in a] if isinstance(a, (list, tuple))
                        else a for a in args]
                self.calls.append((_name, keep, dict(kw)))
                return _orig(*args, **kw)
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
    from ws3d_tpu_torch.ops import crop_gather, fused_sa, interpolate, sampling

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
    raise KeyError(name)


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
                      "by_bytes": 0.0} for k in KERNELS}
    with torch.no_grad():
        for name, args, kw in rec.calls:
            key, err, ms, plain, nbytes, ops, note = compare_call(name, args,
                                                                  kw)
            t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
            agg = per_kernel[key]
            agg["err"] = max(agg["err"], err)
            agg["ms"] += ms
            agg["plain"] += plain
            agg["bound"] += max(t_bytes, t_ops)
            agg["by_bytes"] += t_bytes if t_bytes >= t_ops else 0.0
            print(f"#   {key:17s} {note:44s} err {err:.3g} kernel {ms:.4f} ms"
                  f" plain {plain:.3f} ms bound {max(t_bytes, t_ops):.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'})",
                  flush=True)
    for key, agg in per_kernel.items():
        if agg["ms"] == 0.0:
            raise AssertionError(f"kernel {key} was never called on the "
                                 f"main path")
    print(f"# phase 2: {len(rec.calls)} kernel calls compared in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. the main path
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
    launches = dict(_kernels.LAUNCHES)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
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
          f"max spilled {spilled}; launches {launches}", flush=True)

    _profile_batch(fn, bufs[1], 1e3 * sum(times) / len(times))

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

    # ---- 5. report
    table = []
    for key, (source, replaces) in KERNELS.items():
        agg = per_kernel[key]
        table.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": agg["err"], "ms": agg["ms"],
            "plain_ms": agg["plain"], "bound_ms": agg["bound"],
            "bound_by": ("bytes" if agg["by_bytes"] >= agg["bound"] / 2
                         else "operations"),
            "library_ms": None})
    print(json.dumps({"kernels": table}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _profile_batch(fn, batch, batch_ms: float) -> None:
    """One main-path batch under torch.profiler: device time by kernel (the
    hand-written five first) and the device's busy share of a batch timed
    without the profiler (`batch_ms`; the profiler slows the host)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(batch)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    busy = sum(r[1] for r in rows)
    print(f"# phase 3 profile: {busy:.1f} ms of kernels in one batch, "
          f"{100 * busy / batch_ms:.1f} % of the {batch_ms:.1f} ms batch "
          f"({len(rows)} kernel names)")
    ours = ("fps_kernel", "fused_sa_kernel", "three_interp_kernel",
            "crop_gather_kernel")
    rows.sort(key=lambda r: -r[1])
    mine = sum(r[1] for r in rows if any(o in r[0] for o in ours))
    print(f"#   {mine:9.3f} ms in the five hand-written kernels")
    for key, ms, count in rows[:14]:
        print(f"#   {ms:9.3f} ms {count:6d}x  {key[:90]}")
    rest = sum(r[1] for r in rows[14:])
    print(f"#   {rest:9.3f} ms in {max(len(rows) - 14, 0)} other kernels")


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
