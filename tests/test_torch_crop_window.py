"""Kernel 10 (the z-window crop-gather) on the CPU: the port's plain
version, which applies the kernel's own window rule, against
crop_gather_pallas in its z-window mode (interpret mode) and against the
full plain version. Bit-equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu.ops.ball_query_pallas import crop_gather_pallas
from ws3d_tpu_torch.ops import crop_gather as cg


def _scene(rng, B=2, N=1024):
    """z-sorted points along the scene depth (as test_ball_query_pallas's
    window test) and z-ordered centres, one far off."""
    xyz = rng.randn(B, N, 3).astype(np.float32)
    xyz[..., 0] *= 6.0
    xyz[..., 2] = np.abs(xyz[..., 2]) * 15 + 2
    xyz = np.take_along_axis(xyz, np.argsort(xyz[..., 2], axis=1)[..., None],
                             axis=1)
    ch = np.concatenate([xyz.transpose(0, 2, 1),
                         rng.rand(B, 2, N).astype(np.float32)], axis=1)
    cz = np.linspace(4.0, 30.0, 8, dtype=np.float32)
    centers = np.stack([np.zeros_like(cz), cz], axis=-1)[None].repeat(B, 0)
    centers[:, 3, 0] = 70.0
    return xyz, np.ascontiguousarray(ch), centers


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("z_window", [4, 1])
def test_window_plain_matches_pallas_z_window(rng, grouped, z_window):
    xyz, ch, centers = _scene(rng)
    k = 128
    vals, cnt = crop_gather_pallas(
        jnp.asarray(xyz), jnp.asarray(ch), jnp.asarray(centers), 4.0, k,
        grouped=grouped, interpret=True, z_window=z_window,
        center_z=jnp.asarray(centers[..., 1]))
    got, got_cnt = cg.crop_gather(t(xyz), t(ch), t(centers), 4.0, k,
                                  grouped=grouped, z_window=z_window,
                                  center_z=t(centers[..., 1]))
    np.testing.assert_array_equal(n(got_cnt), np.asarray(cnt))
    np.testing.assert_array_equal(n(got), np.stack([np.asarray(v)
                                                    for v in vals]))
    full, full_cnt = cg.crop_gather_plain(t(xyz), t(ch), t(centers), 4.0, k,
                                          grouped)
    assert torch.equal(got, full) and torch.equal(got_cnt, full_cnt)
    c = n(got_cnt)
    assert c[0, 3] == 0 and (c > k).any() and ((c > 0) & (c < k)).any()


def test_windows_hold_every_member_and_are_tight(rng):
    xyz, _, centers = _scene(rng, N=2048)
    xyz[:, 100:140, 2] = xyz[:, 100:101, 2]      # a run of equal z
    centers[:, 5, 1] = xyz[:, 120, 2]            # a centre on that run
    pz, cz = t(xyz[..., 2]), t(centers[..., 1])
    r2 = cg.radius_sq(4.0, "cpu")
    lo, hi = cg.z_windows(pz, cz, r2)
    near = (cz[..., None] - pz[:, None]) ** 2 < r2          # (B, M, N)
    pos = torch.arange(pz.shape[1])
    inside = (pos >= lo[..., None]) & (pos < hi[..., None])
    assert torch.equal(near, inside)             # contiguous, exact edges
    member = cg._bev_member(t(xyz), t(centers), r2)
    assert not (member & ~inside).any()


@pytest.mark.parametrize("z_window", [1, 3, 1000])
def test_budget_never_changes_the_crop(rng, z_window):
    """A window over the budget scans all N: the same crop at any W."""
    xyz, ch, centers = _scene(rng, N=2048)
    ref = cg.crop_gather_plain(t(xyz), t(ch), t(centers), 4.0, 96)
    got = cg.crop_gather_window_plain(t(xyz), t(ch), t(centers), 4.0, 96,
                                      z_window=z_window)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_dispatch_rule(rng, monkeypatch):
    """Window mode only when both z_window and center_z are given."""
    xyz, ch, centers = _scene(rng, B=1, N=256)
    calls = []
    monkeypatch.setattr(cg, "crop_gather_window_plain",
                        lambda *a: calls.append(a[-1]) or "window")
    args = (t(xyz), t(ch), t(centers), 4.0, 32)
    assert cg.crop_gather(*args, z_window=8,
                          center_z=t(centers[..., 1])) == "window"
    assert calls == [8]
    for kw in ({"z_window": 8}, {"center_z": t(centers[..., 1])}, {}):
        vals, _ = cg.crop_gather(*args, **kw)
        assert torch.equal(vals, cg.crop_gather_plain(*args)[0])
    with pytest.raises(ValueError):
        cg.crop_gather(*args, z_window=0, center_z=t(centers[..., 1]))
    with pytest.raises(ValueError):
        cg.crop_gather(*args, z_window=4, center_z=t(centers[0, :, 1]))
