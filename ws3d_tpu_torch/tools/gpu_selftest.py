"""GPU self-test: each CUDA kernel of ws3d_tpu_torch/ops against its plain
PyTorch version on the card, with CUDA-event times of both.

    python -m ws3d_tpu_torch.tools.gpu_selftest

Shapes: tools/tpu_selftest.py's for the ball query (4 x 16,384 points,
4,096 centres, r 0.1 / 0.5, 16 / 32 samples), FPS (4 x 16,384 -> 4,096)
and the 3-NN search (4 x 16,384 over 4 x 4,096 points), on clouds of
N(0, 10) coordinates from seed 0; then the 3-NN interpolation, both fused
SA searches, the SA on given indices, the crop-gather (both slot orders and
the z window), the wrapped ball query and the windowed interpolation at
the same scale, the window kernels on the clouds sorted by z. Indices,
counts and gathers must be exact, sums within the tolerances the kernels'
tests state. Prints the card's name and power limit, one line a kernel
and SELFTEST PASSED or FAILED; exits 1 on a failure. Needs a CUDA device:
there is no CPU run.
"""
from __future__ import annotations

import subprocess
import sys

import torch


def card_line() -> str:
    """nvidia-smi's name and power limit of the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """ms a call of `fn` by CUDA events over `reps` calls, after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_err(a, b) -> float:
    if isinstance(a, (list, tuple)):
        return max(_max_err(x, y) for x, y in zip(a, b))
    if a.shape != b.shape:
        return float("inf")
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def _scale(b) -> float:
    if isinstance(b, (list, tuple)):
        return max(_scale(x) for x in b)
    return float(b.float().abs().max()) if b.numel() else 0.0


def checks(device):
    """[(name, kernel fn, plain fn, tolerance(plain output))]."""
    from ws3d_tpu_torch.ops import (ball_query, crop_gather, fused_sa,
                                    fused_sa_idx, interpolate, sampling)
    g = torch.Generator(device="cpu").manual_seed(0)

    def cloud(b, n, spread=10.0):
        return (torch.randn(b, n, 3, generator=g) * spread).to(device)

    def by_z(x):
        order = torch.sort(x[..., 2], dim=1, stable=True).indices
        return torch.gather(x, 1, order[..., None].expand(-1, -1, 3))

    def mlp(widths):
        ks = [(torch.randn(a, b, generator=g) * 0.3).to(device)
              for a, b in zip(widths[:-1], widths[1:])]
        bs = [(torch.randn(b, generator=g) * 0.1).to(device)
              for b in widths[1:]]
        return ks, bs

    xyz, q = cloud(4, 16384), cloud(4, 4096)
    radii, ks = [0.1, 0.5], [16, 32]
    unk, kno = cloud(4, 16384), cloud(4, 4096)
    feats = torch.rand(4, 4096, 64, generator=g).to(device)
    pts, cen = cloud(4, 4096, 3.0), cloud(4, 1024, 3.0)
    spts, scen = by_z(pts), by_z(cen)
    pfeat = torch.rand(4, 4096, 32, generator=g).to(device)
    w, b = mlp([35, 64, 64, 128])
    idx = ball_query.ball_query_multi_plain([0.5], [32], pts, cen)[0]
    scene = by_z(cloud(4, 16384, 15.0))
    ch = torch.cat([scene.transpose(1, 2),
                    torch.rand(4, 2, 16384, generator=g).to(device)],
                   1).contiguous()
    crops = scene[:, ::256, [0, 2]].contiguous()               # 64 centres
    crops3 = scene[:1, ::256].contiguous()
    sunk, skno = by_z(unk), by_z(kno)

    exact = lambda ref: 0.0                                     # noqa: E731
    return [
        ("ball_query (kernel 6)",
         lambda: ball_query.ball_query_multi_cuda(radii, ks, xyz, q),
         lambda: ball_query.ball_query_multi_plain(radii, ks, xyz, q),
         exact),
        ("fps (kernel 1)",
         lambda: sampling.fps_cuda(xyz, 4096)[0],
         lambda: sampling.fps_plain(xyz, 4096), exact),
        ("three_nn (kernel 7)",
         lambda: interpolate.three_nn_cuda(unk, kno),
         lambda: interpolate.three_nn_plain(unk, kno), exact),
        ("three_interpolate (kernel 4)",
         lambda: interpolate.three_interpolate_cuda(unk, kno, feats),
         lambda: interpolate.three_interpolate_plain(unk, kno, feats),
         lambda ref: 1e-4 + 1e-5 * _scale(ref)),
        ("fused_sa full (kernel 3)",
         lambda: fused_sa.fused_sa_cuda(pts, pfeat, cen, 0.5, 32, w, b,
                                        False),
         lambda: fused_sa.fused_sa_plain(pts, pfeat, cen, 0.5, 32, w, b),
         lambda ref: 1e-3 + 1e-4 * _scale(ref)),
        ("fused_sa window (kernel 2)",
         lambda: fused_sa.fused_sa_cuda(spts, pfeat, scen, 0.5, 32, w, b,
                                        True),
         lambda: fused_sa.fused_sa_plain(spts, pfeat, scen, 0.5, 32, w, b),
         lambda ref: 1e-3 + 1e-4 * _scale(ref)),
        ("fused_sa_idx (kernel 9)",
         lambda: fused_sa_idx.fused_sa_idx_cuda(pts, pfeat, cen, idx, w, b),
         lambda: fused_sa_idx.fused_sa_idx_plain(idx, pts, pfeat, cen, w, b),
         lambda ref: 1e-6 + 1e-4 * _scale(ref)),
        ("crop_gather grouped (kernel 5)",
         lambda: crop_gather.crop_gather_cuda(scene, ch, crops, 4.0, 512,
                                              True),
         lambda: crop_gather.crop_gather_plain(scene, ch, crops, 4.0, 512,
                                               True), exact),
        ("crop_gather s % cnt (kernel 5)",
         lambda: crop_gather.crop_gather_cuda(scene, ch, crops, 4.0, 512,
                                              False),
         lambda: crop_gather.crop_gather_plain(scene, ch, crops, 4.0, 512,
                                               False), exact),
        ("crop_gather z window (kernel 10)",
         lambda: crop_gather.crop_gather_cuda(scene, ch, crops, 4.0, 512,
                                              True, 32),
         lambda: crop_gather.crop_gather_window_plain(scene, ch, crops, 4.0,
                                                      512, True, 32), exact),
        ("ball_query_wrap (kernel 6w)",
         lambda: ball_query.ball_query_wrap_cuda([4.0], [2048], scene[:1],
                                                 crops3),
         lambda: ball_query.ball_query_wrap_plain([4.0], [2048], scene[:1],
                                                  crops3), exact),
        ("three_interpolate window (kernel 8)",
         lambda: interpolate.three_interpolate_window_cuda(sunk, skno,
                                                           feats),
         lambda: interpolate.three_interpolate_window_plain(sunk, skno,
                                                            feats),
         lambda ref: 1e-4 + 1e-5 * _scale(ref)),
    ]


def run() -> int:
    """Run every check on the current CUDA device; returns the number of
    failures. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("gpu_selftest needs a CUDA device; the kernels' "
                           "CPU tests are tests/test_torch_*.py")
    from ws3d_tpu_torch.ops import _kernels
    _kernels.library()
    print(f"card: {card_line()}", flush=True)
    failures = 0
    with torch.no_grad():
        for name, kernel, plain, tol in checks(torch.device("cuda")):
            got = kernel()
            # the plain versions run once (the slowest takes seconds): the
            # reference call is the timed one
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ref = plain()
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            err, bound = _max_err(got, ref), tol(ref)
            ok = err <= bound
            failures += not ok
            print(f"{name:36s} {'OK' if ok else 'FAIL'}  max|diff| "
                  f"{err:.3g} (gate {bound:.3g})  kernel "
                  f"{cuda_ms(kernel):.4f} ms  plain {plain_ms:.3f} ms",
                  flush=True)
    print("SELFTEST", "FAILED" if failures else "PASSED", flush=True)
    return failures


def main(argv=None) -> int:
    return 1 if run() else 0


if __name__ == "__main__":
    sys.exit(main())
