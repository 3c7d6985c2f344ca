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
