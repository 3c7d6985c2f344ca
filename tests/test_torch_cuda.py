"""Each CUDA kernel against its plain PyTorch version on the card (small
shapes; chip_smoke.py runs the main-path shapes). Marked `cuda`: without a
CUDA device these skip. Run them on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(--noconftest: tests/conftest.py imports JAX, which the card's machine
need not have.)
"""
import numpy as np
import pytest
import torch

from torch_port_helpers import random_mlp, sorted_cloud

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.RandomState(42)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_fps_kernel(dev, rng):
    from ws3d_tpu_torch.ops.sampling import fps_cuda, fps_plain, gather_points
    for N, npoint in [(128, 32), (512, 256), (4096, 512)]:
        xyz = torch.from_numpy(rng.randn(3, N, 3).astype(np.float32)).to(dev)
        idx, coords = fps_cuda(xyz, npoint)
        ref = fps_plain(xyz, npoint)
        assert torch.equal(idx, ref)
        assert torch.equal(coords, gather_points(xyz, ref.long()))


@pytest.mark.parametrize("window", [True, False])
def test_fused_sa_kernel(dev, rng, window):
    from ws3d_tpu_torch.ops.fused_sa import fused_sa_cuda, fused_sa_plain
    xyz, feat = sorted_cloud(rng, 2, 1024, 5)
    new_xyz = xyz[:, np.sort(rng.choice(1024, 128, replace=False))]
    ks, bs = random_mlp(rng, 8, [32, 32, 64])
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (xyz, feat, new_xyz)]
    ks = [torch.from_numpy(k).to(dev) for k in ks]
    bs = [torch.from_numpy(b).to(dev) for b in bs]
    got = fused_sa_cuda(*args, 0.8, 16, ks, bs, window)
    ref = fused_sa_plain(*args, 0.8, 16, ks, bs)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


def test_interpolate_kernel(dev, rng):
    from ws3d_tpu_torch.ops.interpolate import (three_interpolate_cuda,
                                                three_interpolate_plain)
    for m in (1, 2, 300):
        u = torch.from_numpy(rng.randn(2, 700, 3).astype(np.float32)).to(dev)
        k = torch.from_numpy(rng.randn(2, m, 3).astype(np.float32)).to(dev)
        f = torch.from_numpy(rng.randn(2, m, 24).astype(np.float32)).to(dev)
        torch.testing.assert_close(three_interpolate_cuda(u, k, f),
                                   three_interpolate_plain(u, k, f),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grouped", [True, False])
def test_crop_gather_kernel(dev, rng, grouped):
    from ws3d_tpu_torch.ops.crop_gather import (crop_gather_cuda,
                                                crop_gather_plain)
    pts = rng.randn(2, 2000, 3).astype(np.float32) * 6
    pts = pts[np.arange(2)[:, None], np.argsort(pts[..., 2], axis=1)]
    ch = rng.rand(2, 5, 2000).astype(np.float32)
    centers = rng.randn(2, 16, 2).astype(np.float32) * 6
    centers[:, 0] = 80.0
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (pts, ch, centers)]
    vals, cnt = crop_gather_cuda(*args, 4.0, 128, grouped)
    rv, rc = crop_gather_plain(*args, 4.0, 128, grouped)
    assert torch.equal(cnt, rc)
    assert torch.equal(vals, rv)


def test_ball_query_kernel(dev, rng):
    from ws3d_tpu_torch.ops.ball_query import (ball_query_multi_cuda,
                                               ball_query_multi_plain)
    xyz, _ = sorted_cloud(rng, 2, 4096, 1, spread=2.0)
    new_xyz = xyz[:, np.sort(rng.choice(4096, 1024, replace=False))].copy()
    new_xyz[:, :8] = 50.0                       # empty balls
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (xyz, new_xyz)]
    for radii, ks in (([0.1, 0.5], [16, 32]), ([0.3], [8]),
                      ([0.2, 0.4, 0.8, 1.6], [4, 8, 16, 64])):
        got = ball_query_multi_cuda(radii, ks, *args)
        ref = ball_query_multi_plain(radii, ks, *args)
        for g, r in zip(got, ref):
            assert g.dtype == torch.int32
            assert torch.equal(g, r)


def test_three_nn_kernel(dev, rng):
    from ws3d_tpu_torch.ops.interpolate import three_nn_cuda, three_nn_plain
    for m in (1, 2, 3, 300, 2500):
        u = torch.from_numpy(rng.randn(2, 700, 3).astype(np.float32)).to(dev)
        k = torch.from_numpy(rng.randn(2, m, 3).astype(np.float32)).to(dev)
        if m > 3:
            k[:, 1] = k[:, 0]                    # a tie
        d2, idx = three_nn_cuda(u, k)
        rd2, ridx = three_nn_plain(u, k)
        assert torch.equal(idx, ridx)
        assert torch.equal(d2, rd2)


def test_interpolate_backward(dev, rng):
    from ws3d_tpu_torch.ops.interpolate import (interpolate_features,
                                                three_interpolate_plain)
    u = torch.from_numpy(rng.randn(2, 3000, 3).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.randn(2, 700, 3).astype(np.float32)).to(dev)
    f = torch.from_numpy(rng.randn(2, 700, 64).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.randn(2, 3000, 64).astype(np.float32)).to(dev)
    f1 = f.clone().requires_grad_(True)
    f2 = f.clone().requires_grad_(True)
    (interpolate_features(u, k, f1) * g).sum().backward()
    (three_interpolate_plain(u, k, f2) * g).sum().backward()
    # atomics and another order of the three weighted rows
    torch.testing.assert_close(f1.grad, f2.grad, atol=1e-5, rtol=1e-5)


def test_fused_sa_idx_kernel(dev, rng):
    from ws3d_tpu_torch.ops.fused_sa_idx import (fused_sa_idx_cuda,
                                                 fused_sa_idx_plain)
    from ws3d_tpu_torch.ops.grouping import ball_query
    xyz, feat = sorted_cloud(rng, 2, 512, 5)
    new_xyz = xyz[:, np.sort(rng.choice(512, 128, replace=False))]
    ks, bs = random_mlp(rng, 8, [32, 32, 64])
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (xyz, feat, new_xyz)]
    ks = [torch.from_numpy(k).to(dev) for k in ks]
    bs = [torch.from_numpy(b).to(dev) for b in bs]
    for idx in (ball_query(0.8, 16, args[0], args[2]),
                torch.randint(0, 512, (2, 128, 24), dtype=torch.int32,
                              device=dev)):
        got = fused_sa_idx_cuda(*args, idx, ks, bs)
        ref = fused_sa_idx_plain(idx, *args, ks, bs)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("window", [True, False])
def test_fused_sa_backward(dev, rng, window):
    from ws3d_tpu_torch.ops.fused_sa import fused_sa_plain, fused_sa_train
    xyz, feat = sorted_cloud(rng, 2, 512, 5)
    new_xyz = xyz[:, np.sort(rng.choice(512, 128, replace=False))]
    ks, bs = random_mlp(rng, 8, [32, 32, 64])
    g = torch.from_numpy(rng.randn(2, 128, 64).astype(np.float32)).to(dev)
    grads = []
    for fn in (lambda *a: fused_sa_train(*a, window),
               lambda *a: fused_sa_plain(*a)):
        leaves = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  .requires_grad_(True) for a in (xyz, feat, new_xyz)]
        kt = [torch.from_numpy(k).to(dev).requires_grad_(True) for k in ks]
        bt = [torch.from_numpy(b).to(dev).requires_grad_(True) for b in bs]
        (fn(*leaves, 0.8, 16, kt, bt) * g).sum().backward()
        grads.append([a.grad for a in leaves + kt + bt])
    for a, b in zip(*grads):
        # scatter-add atomics sum in another order
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()),
                                   rtol=0)


def test_ball_query_wrap_kernel(dev, rng):
    from ws3d_tpu_torch.ops.ball_query import (ball_query_wrap_cuda,
                                               ball_query_wrap_plain)
    xyz = rng.randn(2, 16384, 3).astype(np.float32) * 20
    xyz[..., 1] = 0.0
    centers = xyz[:, rng.choice(16384, 64, replace=False)].copy()
    centers[:, 0] = 500.0                       # an empty ball
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (xyz, centers)]
    for radii, ks in (([4.0], [2048]), ([0.5, 4.0], [16, 100])):
        idx, cnt = ball_query_wrap_cuda(radii, ks, *args)
        ridx, rcnt = ball_query_wrap_plain(radii, ks, *args)
        for a, b in zip(idx + cnt, ridx + rcnt):
            assert a.dtype == torch.int32
            assert torch.equal(a, b)
        assert int(cnt[-1][:, 0].max()) == 0
        assert bool((cnt[-1] < ks[-1]).any() & (cnt[-1] > 0).any())


def test_interpolate_window_kernel(dev, rng):
    """Kernel 8 against its plain version (neighbours exact), kernel 7 and
    kernel 4 (bit-equal) on sorted clouds with a tie, with equal z (every
    known z rounded to 0.5 m) and m < 3, and at FP3's shape, where the
    channels are split over blocks and only the first split writes the
    neighbours."""
    from ws3d_tpu_torch.ops.interpolate import (
        three_interpolate_cuda, three_interpolate_window_cuda,
        three_interpolate_window_plain, three_nn_cuda, three_nn_window_plain)
    for n, m, C, equal_z in ((4096, 1024, 24, False), (700, 64, 24, False),
                             (700, 64, 24, True), (256, 64, 512, False),
                             (50, 2, 24, False), (40, 1, 24, False)):
        u, _ = sorted_cloud(rng, 2, n, 1, spread=4.0)
        k, f = sorted_cloud(rng, 2, m, C, spread=4.0)
        if equal_z:
            k[..., 2] = np.round(k[..., 2] * 2.0) * 0.5
        if m > 3:
            k[:, 1] = k[:, 0]                    # a tie
        u, k, f = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in (u, k, f))
        out, d2, idx = three_interpolate_window_cuda(u, k, f, with_nn=True)
        rd2, ridx = three_nn_window_plain(u, k)
        assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
        assert torch.equal(idx, three_nn_cuda(u, k)[1])
        # kernel 4's arithmetic on kernel 7's neighbours: bit-equal
        assert torch.equal(out, three_interpolate_cuda(u, k, f))
        torch.testing.assert_close(out,
                                   three_interpolate_window_plain(u, k, f),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_u,m,C", [(16384, 4096, 128), (1000, 250, 64)])
def test_interpolate_window_unsorted(dev, rng, n_u, m, C):
    """Where the known points are not sorted by z, kernel 8's chunk ends
    bound nothing: each query still gets three distinct known points in
    (d2, index) order with their exact d2, each no nearer than the true
    neighbour of its rank (kernel 7), and kernel 4's weights on them, but
    not always the true ones (tests/test_torch_interpolate_window.py
    emulates this search on the CPU)."""
    from ws3d_tpu_torch.ops.interpolate import (
        _weighted_rows, three_interpolate_window_cuda, three_nn_cuda)
    unknown = _search_cloud(rng, 2, n_u, "sorted")
    known = np.ascontiguousarray(unknown[:, ::n_u // m][:, :m]
                                 [:, rng.permutation(m)])
    feats = rng.randn(2, m, C).astype(np.float32)
    u, k, f = (torch.from_numpy(a).to(dev) for a in (unknown, known, feats))
    out, d2, idx = three_interpolate_window_cuda(u, k, f, with_nn=True)
    rd2, ridx = three_nn_cuda(u, k)
    pts = torch.gather(k, 1, idx.long().reshape(2, -1, 1).expand(
        -1, -1, 3)).reshape(2, n_u, 3, 3)
    dd = u[:, :, None] - pts
    assert torch.equal(d2, (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1])
                       + dd[..., 2] * dd[..., 2])
    assert bool(((d2[..., :2] < d2[..., 1:])
                 | ((d2[..., :2] == d2[..., 1:])
                    & (idx[..., :2] < idx[..., 1:]))).all())
    assert bool((d2 >= rd2).all())
    assert not torch.equal(idx, ridx)
    torch.testing.assert_close(out, _weighted_rows(f, d2, idx), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("z_window", [1, 4, 16])
def test_crop_gather_window_kernel(dev, rng, z_window):
    from ws3d_tpu_torch.ops.crop_gather import (crop_gather_cuda,
                                                crop_gather_window_plain)
    pts = rng.randn(2, 4096, 3).astype(np.float32) * 6
    pts[..., 2] = np.abs(pts[..., 2]) * 4
    pts = pts[np.arange(2)[:, None], np.argsort(pts[..., 2], axis=1)]
    ch = rng.rand(2, 5, 4096).astype(np.float32)
    centers = np.stack([rng.randn(2, 16).astype(np.float32) * 6,
                        np.sort(rng.rand(2, 16).astype(np.float32) * 30,
                                axis=1)], axis=-1)
    centers[:, 0] = 80.0
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (pts, ch, centers)]
    full_v, full_c = crop_gather_cuda(*args, 4.0, 512, True)
    vals, cnt = crop_gather_cuda(*args, 4.0, 512, True, z_window)
    rv, rc = crop_gather_window_plain(*args, 4.0, 512, True, z_window)
    assert torch.equal(cnt, rc) and torch.equal(cnt, full_c)
    assert torch.equal(vals, rv) and torch.equal(vals, full_v)


def _tie_cloud(rng, R, N, spread=10.0):
    """R rows of N points with exact duplicates: the second half of each
    row repeats points of the first (as the EVAL loader's padding does), so
    equal min-d2 values meet across every slice border of the cluster
    kernel."""
    xyz = (rng.randn(R, N, 3) * spread).astype(np.float32)
    src = rng.randint(0, N // 2, (R, N - N // 2))
    xyz[:, N // 2:] = np.take_along_axis(xyz[:, :N // 2], src[..., None], 1)
    return xyz


@pytest.mark.parametrize("R,N,npoint", [(1, 16384, 4096), (16, 16384, 4096),
                                        (1024, 512, 256), (16, 1024, 256)])
def test_fps_row_classes(dev, rng, R, N, npoint):
    """Kernel 1 at the main path's row classes, indices and coordinates
    exact against the plain version (the cluster route above 1,024 points,
    the warp route below)."""
    from ws3d_tpu_torch.ops.sampling import fps_cuda, fps_plain, gather_points
    xyz = torch.from_numpy(_tie_cloud(rng, R, N)).to(dev)
    ref = fps_plain(xyz, npoint)
    idx, coords = fps_cuda(xyz, npoint)
    assert torch.equal(idx, ref)
    assert torch.equal(coords, gather_points(xyz, ref.long()))


def test_fps_routes_bench(dev, tmp_path):
    """csrc/bench/fps_routes.cu builds and passes its own checks: both of
    kernel 1's routes agree at every row class, row 0 matches its host
    reference, and 16,384-point rows run as clusters of 8 CTAs or more."""
    import subprocess
    from ws3d_tpu_torch.ops import _kernels
    src = _kernels.CSRC / "bench" / "fps_routes.cu"
    exe = tmp_path / "fps_routes"
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-ffp-contract=off",
                    "-o", str(exe), str(src)], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "ok"


@pytest.mark.parametrize("S", [8, 16, 24, 32])
def test_fused_sa_window_tensor_cores(dev, rng, S):
    """Kernel 2's 3xTF32 MLP against the f32 plain version at the
    backbone's widest stages (Cin 259 with a 196-wide layer; Cin 515 with a
    384-wide one), with empty balls and a ragged last block, within the
    chip_smoke gate 1e-3 + 1e-4 max|ref|."""
    from ws3d_tpu_torch.ops.fused_sa import fused_sa_cuda, fused_sa_plain
    for C, widths, P, M, r in ((256, [128, 196, 256], 1024, 200, 1.0),
                               (512, [256, 384, 512], 256, 64, 2.0)):
        xyz, feat = sorted_cloud(rng, 2, P, C, spread=2.0)
        new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))].copy()
        new_xyz[:, :3, 0] = 50.0                # empty balls, z order kept
        ks, bs = random_mlp(rng, C + 3, widths)
        ks = [k * 0.3 for k in ks]
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (xyz, feat, new_xyz)]
        ks = [torch.from_numpy(k).to(dev) for k in ks]
        bs = [torch.from_numpy(b).to(dev) for b in bs]
        got = fused_sa_cuda(*args, r, S, ks, bs, True)
        ref = fused_sa_plain(*args, r, S, ks, bs)
        err = float((got - ref).abs().max())
        assert err <= 1e-3 + 1e-4 * float(ref.abs().max()), (C, S, err)


# kernel 3's main-path shapes, cut to 2 batch rows: backbone SA1 (both
# scales, random MLPs at the backbone's widths) and stage-2 SA2 (the fitted
# MLP); M not a multiple of the block's queries leaves a ragged last block
FULL_CASES = {  # name: (C, P, M, S, radius, widths or None for the fitted)
    "backbone_s16": (96, 4096, 203, 16, 0.5, [64, 64, 128]),
    "backbone_s32": (96, 4096, 203, 32, 1.0, [64, 96, 128]),
    "stage2_s64": (128, 128, 32, 64, 1.0, None),
    "stage2_s64_ragged": (128, 128, 33, 64, 1.0, None),
}


def _full_case(rng, dev, name):
    """Points, features, queries (the first three with empty balls) and the
    MLP of a FULL_CASES entry, on `dev`."""
    from torch_port_helpers import WEIGHTS
    C, P, M, S, r, widths = FULL_CASES[name]
    xyz, feat = sorted_cloud(rng, 2, P, C, spread=2.0 if P > 1024 else 0.8)
    new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))].copy()
    new_xyz[:, :3, 0] = 50.0
    if widths is None:
        key = "params/rcnn/sa_score_0/sa_2/mlp_0/Dense_{}/{}"
        with np.load(WEIGHTS) as z:
            ks, bs = ([z[key.format(i, w)].astype(np.float32)
                       for i in range(3)] for w in ("kernel", "bias"))
    else:
        ks, bs = random_mlp(rng, C + 3, widths)
        ks = [k * 0.3 for k in ks]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (xyz, feat, new_xyz)]
    return (args, [torch.from_numpy(k).to(dev) for k in ks],
            [torch.from_numpy(b).to(dev) for b in bs], S, r)


@pytest.mark.parametrize("name", sorted(FULL_CASES))
def test_fused_sa_full_tensor_cores(dev, rng, name):
    """Kernel 3 (full mode) on the 3xTF32 tensor-core routine against the
    f32 plain version at its main-path widths, with empty balls and a
    ragged last block, within the chip_smoke gate 1e-3 + 1e-4 max|ref|."""
    from ws3d_tpu_torch.ops.fused_sa import fused_sa_cuda, fused_sa_plain
    args, ks, bs, S, r = _full_case(rng, dev, name)
    got = fused_sa_cuda(*args, r, S, ks, bs, False)
    ref = fused_sa_plain(*args, r, S, ks, bs)
    err = float((got - ref).abs().max())
    assert float(ref.abs().max()) > 0.1
    assert err <= 1e-3 + 1e-4 * float(ref.abs().max()), (name, err)


@pytest.mark.parametrize("name", sorted(FULL_CASES))
def test_fused_sa_idx_tensor_cores(dev, rng, name):
    """Kernel 9 (given mode) at kernel 3's shapes: on kernel 6's indices it
    runs the same rows through the same routine as the full mode, so the
    two agree bit for bit; on random indices with S + 8 slots (not a
    multiple of 16) it holds its chip_smoke gate 1e-4 max|ref| + 1e-6
    against the plain version."""
    from ws3d_tpu_torch.ops.fused_sa import fused_sa_cuda
    from ws3d_tpu_torch.ops.fused_sa_idx import (fused_sa_idx_cuda,
                                                 fused_sa_idx_plain)
    from ws3d_tpu_torch.ops.grouping import ball_query
    args, ks, bs, S, r = _full_case(rng, dev, name)
    idx = ball_query(r, S, args[0], args[2])
    assert torch.equal(fused_sa_idx_cuda(*args, idx, ks, bs),
                       fused_sa_cuda(*args, r, S, ks, bs, False))
    P, M = args[0].shape[1], args[2].shape[1]
    idx = torch.randint(0, P, (2, M, S + 8), dtype=torch.int32, device=dev)
    got = fused_sa_idx_cuda(*args, idx, ks, bs)
    ref = fused_sa_idx_plain(idx, *args, ks, bs)
    err = float((got - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max()) + 1e-6, (name, err)


def test_fused_sa_layouts_bench(dev, tmp_path):
    """csrc/bench/fused_sa_layouts.cu builds and passes its own checks: at
    every main-path launch shape of the fused SA each sizing gives the kept
    sizing's output bit for bit, and the searching modes give the given
    mode's output on a host ball query's indices bit for bit."""
    import subprocess
    from ws3d_tpu_torch.ops import _kernels
    src = _kernels.CSRC / "bench" / "fused_sa_layouts.cu"
    exe = tmp_path / "fused_sa_layouts"
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-ffp-contract=off",
                    "-o", str(exe), str(src)], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True)
    print(out.stdout)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "ok"


def _search_cloud(rng, B, N, kind):
    """Kernels 6 and 4 inputs of a kind, sorted by z but for "shuffled":
    LiDAR-like scenes ("sorted", "shuffled"), every z equal ("single_z"),
    or points on a 1/8 grid in [-1, 1]^3 ("boundary": many repeated points,
    and many pairs at a d2 of exactly 0.25, r 0.5's r2)."""
    u = rng.rand(B, N, 4).astype(np.float32)
    z = 70.0 * u[..., 0] * u[..., 1] + 2.0
    x = (u[..., 2] - 0.5) * (0.2 + 1.4 * z)
    y = np.where(u[..., 3] < 0.6, 1.7 + 0.05 * rng.randn(B, N),
                 1.7 - 2.0 * rng.rand(B, N))
    pts = np.stack([x, y, z], -1).astype(np.float32)
    if kind == "single_z":
        pts[..., 2] = 7.0
        pts[..., :2] *= 0.05
    elif kind == "boundary":
        pts = (rng.randint(-8, 9, (B, N, 3)) * 0.125).astype(np.float32)
    pts = pts[np.arange(B)[:, None], np.argsort(pts[..., 2], axis=1,
                                                 kind="stable")]
    if kind == "shuffled":
        pts = pts[np.arange(B)[:, None],
                  np.stack([rng.permutation(N) for _ in range(B)])]
    return np.ascontiguousarray(pts)


SEARCH_KINDS = ["sorted", "shuffled", "single_z", "boundary"]


@pytest.mark.parametrize("kind", SEARCH_KINDS)
@pytest.mark.parametrize("N,M,radii,ks", [
    (16384, 4096, [0.1, 0.5], [16, 32]),      # stage-1 SA0
    (4096, 1024, [0.5, 1.0], [16, 32]),       # stage-1 SA1
    (1000, 250, [1.0, 2.0], [16, 32]),        # SA2-like, N % 32 != 0
    (130, 33, [1.0], [64]),                   # RCNN SA2-like, ragged
])
def test_ball_query_pruned(dev, rng, kind, N, M, radii, ks):
    """Kernel 6's staged, pruned scan equals the plain version exactly on
    sorted, shuffled, single-z and radius-boundary clouds at the stage-1
    shapes (2 scenes) and at point counts that are not a multiple of the
    chunk, with an empty ball in every row."""
    from ws3d_tpu_torch.ops.ball_query import (ball_query_multi_cuda,
                                               ball_query_multi_plain)
    xyz = _search_cloud(rng, 2, N, kind)
    new_xyz = np.ascontiguousarray(xyz[:, ::N // M][:, :M])
    new_xyz[:, M // 2] = 500.0
    if kind == "shuffled":
        new_xyz = np.ascontiguousarray(new_xyz[:, rng.permutation(M)])
    args = [torch.from_numpy(a).to(dev) for a in (xyz, new_xyz)]
    got = ball_query_multi_cuda(radii, ks, *args)
    ref = ball_query_multi_plain(radii, ks, *args)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("kind", SEARCH_KINDS)
@pytest.mark.parametrize("n_u,m,C", [
    (16384, 4096, 128),                       # FP0
    (4096, 1024, 256),                        # FP1
    (1000, 250, 64),                          # m % 32 != 0
    (300, 2, 16),                             # m < 3
])
def test_interpolate_pruned(dev, rng, kind, n_u, m, C):
    """Kernel 4's staged, pruned search within the chip_smoke gate
    (1e-4 + 1e-5 max|ref|) of the plain version, on kernel 7's neighbours,
    and bit-equal to kernel 8 where both clouds are sorted by z."""
    from ws3d_tpu_torch.ops.interpolate import (
        _weighted_rows, three_interpolate_cuda, three_interpolate_plain,
        three_interpolate_window_cuda, three_nn_cuda)
    unknown = _search_cloud(rng, 2, n_u, kind)
    known = np.ascontiguousarray(unknown[:, ::max(n_u // m, 1)][:, :m])
    if kind == "shuffled":
        known = np.ascontiguousarray(known[:, rng.permutation(m)])
    feats = rng.randn(2, m, C).astype(np.float32)
    u, k, f = (torch.from_numpy(a).to(dev) for a in (unknown, known, feats))
    got = three_interpolate_cuda(u, k, f)
    ref = three_interpolate_plain(u, k, f)
    err = float((got - ref).abs().max())
    assert err <= 1e-4 + 1e-5 * float(ref.abs().max()), err
    d2, idx = three_nn_cuda(u, k)
    if kind != "shuffled":
        assert torch.equal(got, three_interpolate_window_cuda(u, k, f))
    # the neighbours are kernel 7's: the plain weights on them agree too
    err7 = float((_weighted_rows(f, d2, idx) - got).abs().max())
    assert err7 <= 1e-4 + 1e-5 * float(ref.abs().max()), err7


@pytest.mark.parametrize("kind", SEARCH_KINDS)
@pytest.mark.parametrize("n_u,m", [
    (16384, 4096),                            # stage-1 FP0
    (1024, 256),                              # stage-1 FP2
    (1000, 250),                              # m % 32 != 0
    (300, 2),                                 # m < 3
])
def test_three_nn_pruned(dev, rng, kind, n_u, m):
    """Kernel 7's staged search equals three_nn_plain bit for bit (d2 and
    indices), with its own pre-pass and on the chunk bounds kernel 4's
    pre-pass wrote for the same known cloud (the interpolation backward's
    reuse), and picks kernel 8's neighbours where both clouds are sorted."""
    from ws3d_tpu_torch.ops import _kernels
    from ws3d_tpu_torch.ops.interpolate import (
        three_interpolate_cuda, three_interpolate_window_cuda, three_nn_cuda,
        three_nn_plain)
    unknown = _search_cloud(rng, 2, n_u, kind)
    known = np.ascontiguousarray(unknown[:, ::max(n_u // m, 1)][:, :m])
    if kind == "shuffled":
        known = np.ascontiguousarray(known[:, rng.permutation(m)])
    u, k = (torch.from_numpy(a).to(dev) for a in (unknown, known))
    f = torch.ones((2, m, 4), device=dev)
    rd2, ridx = three_nn_plain(u, k)
    d2, idx = three_nn_cuda(u, k)
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    bounds = _kernels.chunk_bounds_workspace(k)
    three_interpolate_cuda(u, k, f, bounds)
    d2b, idxb = three_nn_cuda(u, k, bounds)
    assert torch.equal(idxb, ridx) and torch.equal(d2b, rd2)
    if kind != "shuffled":
        _, wd2, widx = three_interpolate_window_cuda(u, k, f, with_nn=True)
        assert torch.equal(widx, idx) and torch.equal(wd2, d2)


@pytest.mark.parametrize("kind", SEARCH_KINDS)
def test_ball_query_wrap_pruned(dev, rng, kind):
    """Kernel 6w's staged, pruned count scan at the database path's launch
    (one scene of 16,384 points, y zeroed, the last 3,000 moved FAR; 64
    centres in score order; r 4 m, S 2,048), with an empty ball, a ball of
    more than S members (truncated, with the true count), points with NaN
    z and a centre with NaN z: idx and counts equal the plain version."""
    from ws3d_tpu_torch.ops.ball_query import (ball_query_wrap_cuda,
                                               ball_query_wrap_plain)
    N, M = 16384, 64
    xyz = _search_cloud(rng, 1, N, kind)
    if kind != "shuffled":
        xyz[:, N - 3000:, 0] = xyz[:, N - 3000:, 2] = 1.0e6
    xyz[..., 1] = 0.0
    centers = np.ascontiguousarray(xyz[:, rng.permutation(N - 3000)[:M]])
    xyz[:, 5000:5040:3, 2] = np.nan
    centers[:, 0] = (0.0, 0.0, -50.0)                  # an empty ball
    centers[:, 1, 2] = np.nan
    centers[:, 2] = xyz[:, 0]                          # the densest end
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (xyz, centers)]
    (idx,), (cnt,) = ball_query_wrap_cuda([4.0], [2048], *args)
    (ridx,), (rcnt,) = ball_query_wrap_plain([4.0], [2048], *args)
    assert torch.equal(cnt, rcnt) and torch.equal(idx, ridx)
    assert int(cnt[0, 0]) == 0 and int(cnt[0, 1]) == 0
    if kind in ("sorted", "single_z", "boundary"):
        assert int(cnt.max()) > 2048


@pytest.mark.parametrize("kind", SEARCH_KINDS)
def test_crop_gather_pruned(dev, rng, kind):
    """Kernel 5's listed search at the inference launch (16 scenes of
    16,384 points, 64 centres in score order, r 4 m, k 512, grouped, 5
    channels), with an empty crop and an overfull one (cnt > k), equals
    crop_gather_plain bit for bit on sorted, shuffled, single-z and
    radius-boundary clouds, and kernel 10 at z_window 32 and 1 equals
    crop_gather_window_plain, the shuffled cloud included (its ranges are
    then those of torch.searchsorted on unsorted z), and kernel 5 where the
    cloud is sorted. With points of NaN z (which unsort the cloud) and a
    centre of NaN z, both still equal their plain versions."""
    from ws3d_tpu_torch.ops.crop_gather import (crop_gather_cuda,
                                                crop_gather_plain,
                                                crop_gather_window_plain)
    B, N, M = 16, 16384, 64
    xyz = _search_cloud(rng, B, N, kind)
    ch = np.concatenate([xyz.transpose(0, 2, 1),
                         rng.rand(B, 2, N).astype(np.float32)], axis=1)
    pick = np.stack([rng.permutation(N)[:M] for _ in range(B)])
    centers = xyz[np.arange(B)[:, None], pick][..., [0, 2]]
    centers[:, 0] = (500.0, 500.0)                     # an empty crop
    centers[:, 1] = xyz[:, 0, [0, 2]]                  # overfull
    if kind in ("sorted", "shuffled"):
        centers[:, 1] = (0.0, 4.0)                     # the densest depth

    def check(xyz, centers, sorted_z):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (xyz, ch, centers)]
        vals, cnt = crop_gather_cuda(*args, 4.0, 512, True)
        rv, rc = crop_gather_plain(*args, 4.0, 512, True)
        assert torch.equal(cnt, rc) and torch.equal(vals, rv)
        assert int(cnt[:, 0].max()) == 0
        assert bool((cnt[:, 1] > 512).all())
        for W in (32, 1):
            wv, wc = crop_gather_cuda(*args, 4.0, 512, True, W)
            pv, pc = crop_gather_window_plain(*args, 4.0, 512, True, W)
            assert torch.equal(wc, pc) and torch.equal(wv, pv)
            if sorted_z:
                assert torch.equal(wc, cnt) and torch.equal(wv, vals)
        return cnt
    check(xyz, centers, kind != "shuffled")
    xyz[:, 5000:5040:3, 2] = np.nan
    centers[:, 2, 1] = np.nan
    assert int(check(xyz, centers, False)[:, 2].max()) == 0


def test_fused_sa_full_shuffled(dev, rng):
    """Kernel 3's search is kernel 6's: on a shuffled cloud (nothing to
    skip) at backbone SA1's width it holds the gate 1e-3 + 1e-4 max|ref|
    against the plain version, and kernel 9 on kernel 6's indices equals
    it bit for bit."""
    from ws3d_tpu_torch.ops.fused_sa import fused_sa_cuda, fused_sa_plain
    from ws3d_tpu_torch.ops.fused_sa_idx import fused_sa_idx_cuda
    from ws3d_tpu_torch.ops.grouping import ball_query
    xyz = _search_cloud(rng, 2, 4096, "shuffled")
    feat = rng.rand(2, 4096, 96).astype(np.float32)
    new_xyz = np.ascontiguousarray(xyz[:, rng.permutation(4096)[:203]])
    ks, bs = random_mlp(rng, 99, [64, 64, 128])
    ks = [k * 0.3 for k in ks]
    args = [torch.from_numpy(a).to(dev) for a in (xyz, feat, new_xyz)]
    ks = [torch.from_numpy(k).to(dev) for k in ks]
    bs = [torch.from_numpy(b).to(dev) for b in bs]
    for r, S in ((0.5, 16), (1.0, 32)):
        got = fused_sa_cuda(*args, r, S, ks, bs, False)
        ref = fused_sa_plain(*args, r, S, ks, bs)
        err = float((got - ref).abs().max())
        assert err <= 1e-3 + 1e-4 * float(ref.abs().max()), (S, err)
        idx = ball_query(r, S, args[0], args[2])
        assert torch.equal(fused_sa_idx_cuda(*args, idx, ks, bs), got)


def test_neighbour_search_bench(dev, tmp_path):
    """csrc/bench/neighbour_search.cu builds and passes its own checks:
    kernels 6, 4, 7, 6w, 5 and 10 give the outputs of the searches they
    replaced bit for bit at every main-path launch shape, sorted and
    shuffled, in every sizing tried, kernel 6's first row matches a host
    ball query and kernel 5's first row's counts the host's."""
    import subprocess
    from ws3d_tpu_torch.ops import _kernels
    src = _kernels.CSRC / "bench" / "neighbour_search.cu"
    exe = tmp_path / "neighbour_search"
    subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-ffp-contract=off",
                    "-o", str(exe), str(src)], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True)
    print(out.stdout)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.splitlines()[-1] == "ok"
