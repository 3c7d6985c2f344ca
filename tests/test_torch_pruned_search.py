"""The pruned searches of kernels 6 (ball query) and 4 (3-NN interpolation)
emulated in plain PyTorch, rule for rule as csrc/common.cuh and
csrc/interpolate.cu apply them: 32-point chunks and their z ranges (NaN z
left out), the z term fl(fl(qz - z_near)^2) in float32, kernel 6's visits
in ascending index with a query skipping a chunk whose z term is >= the r2
of each of its unfilled scales, kernel 4's visits outward from the block's
home chunk with a warp skipping a chunk whose z term from the warp's query
range is strictly greater than the warp's largest third-best d2, and the
running top-3 in (d2, index) order. Each emulation must give the plain
version's indices exactly (ball_query_multi_plain, three_nn_plain and
three_interpolate_plain bit for bit) and the JAX references' (the Pallas
kernels in interpret mode and the XLA paths), on z-sorted, shuffled,
clustered and equal-z clouds, points at exactly r2, m < 3 and empty balls;
every chunk a query tests must be one its block stages; and on sorted
clouds the emulated searches test fewer points than the dense scan."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu.ops.ball_query_pallas import ball_query_pallas
from ws3d_tpu.ops.grouping import ball_query_multi as jax_ball_query_multi
from ws3d_tpu.ops.interpolate import _interpolate_xla, _three_nn_chunk
from ws3d_tpu.ops.three_nn_pallas import (three_interpolate_pallas,
                                          three_nn_pallas)
from ws3d_tpu_torch.ops._kernels import CHUNK
from ws3d_tpu_torch.ops.ball_query import ball_query_multi_plain
from ws3d_tpu_torch.ops.grouping import (pairwise_sqdist, radius_sq,
                                         select_in_ball)
from ws3d_tpu_torch.ops.interpolate import (_weighted_rows,
                                            three_interpolate_plain,
                                            three_nn_plain)

INF = float("inf")
BQ_QUERIES = 16        # csrc/ball_query.cu: kBQWarps * kBQPerWarp


def chunk_bounds(pts):
    """(B, N, 3) -> (lo, hi), each (B, ceil(N / CHUNK)): the z range of each
    chunk without its NaN z (+inf, -inf when none is left)."""
    B, N, _ = pts.shape
    nch = -(-N // CHUNK)
    z = torch.full((B, nch * CHUNK), float("nan"))
    z[:, :N] = pts[..., 2]
    z = z.view(B, nch, CHUNK)
    nan = torch.isnan(z)
    return (torch.where(nan, INF, z).amin(-1),
            torch.where(nan, -INF, z).amax(-1))


def zterm(qz, lo, hi):
    """fl(fl(qz - z_near)^2) in float32, z_near the nearer end of [lo, hi],
    0 inside."""
    zero = torch.zeros((), dtype=torch.float32)
    dz = torch.where(qz < lo, qz - lo, torch.where(qz > hi, qz - hi, zero))
    return dz * dz


def zterm_hull(zlo, zhi, lo, hi):
    """The least z term from any z in [zlo, zhi] to [lo, hi]."""
    zero = torch.zeros((), dtype=torch.float32)
    dz = torch.where(zhi < lo, zhi - lo, torch.where(zlo > hi, zlo - hi,
                                                     zero))
    return dz * dz


def _padded_d2(q, pts, nch):
    d2 = pairwise_sqdist(q, pts)
    pad = nch * CHUNK - pts.shape[1]
    return torch.nn.functional.pad(d2, (0, pad), value=INF)


def emulate_ball_query(radii, nsamples, xyz, new_xyz):
    """Kernel 6's pruned scan: -> (per scale (B, M, S) int32 indices,
    points tested a query (B, M), chunks staged a block (B, blocks)).
    Asserts that every chunk a query tests is one its block stages."""
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    lo, hi = chunk_bounds(xyz)
    nch = lo.shape[1]
    r2 = torch.stack([radius_sq(r, "cpu") for r in radii])      # (ns,)
    S = torch.tensor([int(s) for s in nsamples])
    d2 = _padded_d2(new_xyz, xyz, nch)                          # (B, M, P)
    qz = new_xyz[..., 2]
    nblk = -(-M // BQ_QUERIES)
    blk = torch.arange(M) // BQ_QUERIES
    zlo = torch.full((B, nblk), INF).scatter_reduce(1, blk.expand(B, M), qz,
                                                    "amin")
    zhi = torch.full((B, nblk), -INF).scatter_reduce(1, blk.expand(B, M), qz,
                                                     "amax")
    cnt = torch.zeros((B, M, len(radii)), dtype=torch.long)
    thr = r2.max().expand(B, M).clone()
    hits = torch.zeros((B, M, len(radii), nch * CHUNK), dtype=torch.bool)
    tested = torch.zeros((B, M), dtype=torch.long)
    staged = torch.zeros((B, nblk), dtype=torch.long)
    for c in range(nch):
        # warp 0: stage unless the block's range is as far as the largest
        # r2 any of its queries still needs
        tb = torch.full((B, nblk), -INF).scatter_reduce(
            1, blk.expand(B, M), thr, "amax")
        stage = zterm_hull(zlo, zhi, lo[:, c:c + 1], hi[:, c:c + 1]) < tb
        # a warp: test the chunk for a query unless its z term reaches the
        # r2 of each of its unfilled scales
        go = zterm(qz, lo[:, c:c + 1], hi[:, c:c + 1]) < thr
        assert not bool((go & ~torch.gather(stage, 1, blk.expand(B, M)))
                        .any())
        staged += stage.long()
        tested += go.long() * min(CHUNK, N - c * CHUNK)
        part = d2[..., c * CHUNK:(c + 1) * CHUNK, None] < r2     # (B,M,32,ns)
        part &= go[..., None, None]
        hits[..., c * CHUNK:(c + 1) * CHUNK] = part.permute(0, 1, 3, 2)
        cnt += part.sum(2)
        thr = torch.where(cnt < S, r2, -INF).amax(-1)
    outs = tuple(select_in_ball(torch.where(hits[:, :, s, :N], 0.0, 1.0),
                                torch.tensor(0.5), int(k)).to(torch.int32)
                 for s, k in enumerate(nsamples))
    return outs, tested, staged


def _home(zlo, zhi, lo, hi):
    """The middle of the chunks of least z term from [zlo, zhi]."""
    T = zterm_hull(zlo, zhi, lo, hi)
    at = torch.nonzero(T == T.min())[:, 0]
    return int(at.min() + at.max()) // 2


def _merge(d, i, v, j):
    """The first three of the current (d, i) rows and the candidates
    (v, j), in (d2, index) order."""
    dd = torch.cat([d, v], -1)
    ii = torch.cat([i, j.expand(v.shape)], -1)
    o = torch.sort(ii, dim=-1, stable=True).indices
    dd, ii = torch.gather(dd, -1, o), torch.gather(ii, -1, o)
    o = torch.sort(dd, dim=-1, stable=True).indices[..., :3]
    return torch.gather(dd, -1, o), torch.gather(ii, -1, o)


def emulate_three_nn(unknown, known, qpt):
    """Kernel 4's pruned search with qpt queries a thread: -> (d2 (B, n, 3),
    idx (B, n, 3) int32, pairs tested). Asserts that every chunk a warp
    tests is one its block stages."""
    B, nu, _ = unknown.shape
    m = known.shape[1]
    lo, hi = chunk_bounds(known)
    nch = lo.shape[1]
    d2 = _padded_d2(unknown, known, nch)
    bq, wq = 128 * qpt, 32 * qpt
    out_d = torch.full((B, nu, 3), INF)
    out_i = torch.full((B, nu, 3), -1, dtype=torch.long)
    pairs = 0
    for b in range(B):
        for u0 in range(0, nu, bq):
            # past n, copies of the last query
            rows = torch.clamp(torch.arange(u0, u0 + bq), max=nu - 1)
            qz = unknown[b, rows, 2].view(-1, wq)                 # (warps, wq)
            wlo, whi = qz.amin(-1), qz.amax(-1)
            zlo, zhi = wlo.min(), whi.max()
            home = _home(zlo, zhi, lo[b], hi[b])
            d = torch.full((bq // wq, wq, 3), INF)
            i = torch.full((bq // wq, wq, 3), -1, dtype=torch.long)
            wd3 = torch.full((bq // wq,), INF)
            for p in range(2 * max(home, nch - 1 - home) + 1):
                c = home - (p + 1) // 2 if p % 2 else home + p // 2
                if not 0 <= c < nch:
                    continue
                # warp 0 stages the chunk unless the block's range is
                # strictly farther than the block's largest third-best d2
                stage = not bool(zterm_hull(zlo, zhi, lo[b, c], hi[b, c])
                                 > wd3.max())
                go = ~(zterm_hull(wlo, whi, lo[b, c], hi[b, c]) > wd3)
                assert stage or not bool(go.any())
                jn = min(CHUNK, m - c * CHUNK)
                j = torch.arange(c * CHUNK, c * CHUNK + jn)
                v = d2[b, rows, c * CHUNK:c * CHUNK + jn].view(-1, wq, jn)
                nd, ni = _merge(d, i, v, j)
                d = torch.where(go[:, None, None], nd, d)
                i = torch.where(go[:, None, None], ni, i)
                wd3 = torch.where(go, d[..., 2].amax(-1), wd3)
                real = (torch.arange(u0, u0 + bq) < nu).view(-1, wq).sum(-1)
                pairs += int((go.long() * real).sum()) * jn
            keep = min(bq, nu - u0)
            out_d[b, u0:u0 + keep] = d.reshape(-1, 3)[:keep]
            out_i[b, u0:u0 + keep] = i.reshape(-1, 3)[:keep]
    for s in (1, 2):                                  # m < 3
        empty = out_i[..., s] < 0
        out_d[..., s] = torch.where(empty, out_d[..., 0], out_d[..., s])
        out_i[..., s] = torch.where(empty, out_i[..., 0], out_i[..., s])
    return out_d, out_i.to(torch.int32), pairs


# ------------------------------------------------------------------ inputs
def _cloud(rng, B, N, kind, spread=4.0, pts=None):
    """(B, N, 3) float32 clouds of a kind (or the given points), sorted by z
    unless shuffled."""
    x = (rng.randn(B, N, 3) * spread if pts is None else pts).astype(
        np.float32)
    if kind == "clusters":
        centres = rng.randn(B, 6, 3).astype(np.float32) * spread * 2
        x = (centres[np.arange(B)[:, None], rng.randint(0, 6, (B, N))]
             + rng.randn(B, N, 3).astype(np.float32) * 0.3)
    elif kind == "equal_z":
        x[..., 2] = np.round(x[..., 2] * 0.5) * 2.0        # a few z values
    x = x[np.arange(B)[:, None], np.argsort(x[..., 2], axis=1, kind="stable")]
    if kind == "shuffled":
        x = x[np.arange(B)[:, None],
              np.stack([rng.permutation(N) for _ in range(B)])]
    return np.ascontiguousarray(x, dtype=np.float32)


def _lidar(rng, B, N, kind):
    """(B, N, 3) LiDAR-like scenes in camera coordinates: depth z in
    [2, 72] m biased to the near range, x across a widening frustum, 60 %
    of the points on a ground layer at y 1.7 m; sorted by z unless
    shuffled."""
    u = rng.rand(B, N, 4).astype(np.float32)
    z = 70.0 * u[..., 0] * u[..., 1] + 2.0
    x = (u[..., 2] - 0.5) * (0.2 + 1.4 * z)
    y = np.where(u[..., 3] < 0.6, 1.7 + 0.05 * rng.randn(B, N),
                 1.7 - 2.0 * rng.rand(B, N))
    return _cloud(rng, B, N, kind, pts=np.stack([x, y, z], -1))


def _queries(rng, xyz, M):
    """Every (N / M)-th point, in index order."""
    step = xyz.shape[1] // M
    return np.ascontiguousarray(xyz[:, ::step][:, :M])


KINDS = ["sorted", "shuffled", "clusters", "equal_z"]


# ------------------------------------------------------------- kernel 6
@pytest.mark.parametrize("kind", KINDS)
def test_ball_query_emulation_matches_plain(rng, kind):
    """At the backbone SA-1 radii and S, N = 2,000 (not a multiple of the
    chunk): the emulated pruned scan equals the plain version exactly."""
    xyz = _cloud(rng, 2, 2000, kind)
    new_xyz = _queries(rng, xyz, 500)
    new_xyz[:, 7] = 60.0                                # an empty ball
    radii, ks = [0.5, 1.5], [16, 32]
    got, tested, _ = emulate_ball_query(radii, ks, t(xyz), t(new_xyz))
    ref = ball_query_multi_plain(radii, ks, t(xyz), t(new_xyz))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    assert int(tested[:, 7].max()) == 0


@pytest.mark.parametrize("kind", KINDS)
def test_ball_query_emulation_matches_jax(rng, kind):
    """The same against ball_query_pallas (interpret mode) and the JAX XLA
    path, at tests/test_ball_query_pallas.py's first shape."""
    xyz = _cloud(rng, 2, 512, kind, spread=3.0)
    new_xyz = _queries(rng, xyz, 64)
    radii, ks = [0.5, 1.5], [8, 16]
    got, _, _ = emulate_ball_query(radii, ks, t(xyz), t(new_xyz))
    for ref in (ball_query_pallas(radii, ks, jnp.asarray(xyz),
                                  jnp.asarray(new_xyz), interpret=True),
                jax_ball_query_multi(radii, ks, jnp.asarray(xyz),
                                     jnp.asarray(new_xyz))):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(n(g), np.asarray(r))


def test_ball_query_points_at_exactly_r2(rng):
    """Points whose term-rounded d2 is exactly r2 (0.25: dz = 0.5, or
    dx = 0.3 and dz = 0.4 in binary fractions that square exactly) are
    outside the ball, and a chunk whose z term is exactly r2 is skipped:
    the emulation still equals the plain version and the XLA path."""
    B, N = 1, 256
    xyz = rng.uniform(-0.05, 0.05, (B, N, 3)).astype(np.float32)
    xyz[:, :, 2] += np.linspace(-3, 3, N, dtype=np.float32)
    xyz = xyz[:, np.argsort(xyz[0, :, 2], kind="stable")]
    q = np.array([[[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)
    edge = np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5], [0.5, 0.0, 0.0],
                     [0.0, 0.0, 1.5], [0.0, 0.0, 0.5]], np.float32)
    xyz = np.concatenate([xyz, edge[None]], axis=1)
    xyz = np.ascontiguousarray(
        xyz[:, np.argsort(xyz[0, :, 2], kind="stable")])
    d2 = n(pairwise_sqdist(t(q), t(xyz)))
    assert (d2 == np.float32(0.25)).sum() >= 4
    radii, ks = [0.5], [64]
    got, _, _ = emulate_ball_query(radii, ks, t(xyz), t(q))
    assert torch.equal(got[0], ball_query_multi_plain(radii, ks, t(xyz),
                                                      t(q))[0])
    ref = jax_ball_query_multi(radii, ks, jnp.asarray(xyz), jnp.asarray(q))
    np.testing.assert_array_equal(n(got[0]), np.asarray(ref[0]))
    for row, idx in zip(d2[0], n(got[0])[0]):
        assert not (row[idx] == np.float32(0.25)).any()


def test_ball_query_empty_balls_give_zeros(rng):
    xyz = _cloud(rng, 2, 700, "sorted")
    new_xyz = np.full((2, 40, 3), 80.0, np.float32)
    got, tested, staged = emulate_ball_query([0.5, 1.0], [8, 16], t(xyz),
                                             t(new_xyz))
    for g in got:
        assert not bool(g.any())
    assert int(tested.sum()) == 0 and int(staged.sum()) == 0


def test_ball_query_tests_fewer_points_on_sorted_clouds(rng):
    """On a z-sorted LiDAR-like scene (backbone SA-1: 2,048 points, every
    fourth a query, r 0.5 / 1.0) the pruned scan tests a fraction of the
    points of the index-order scan (each query up to the S-th hit of the
    scale that fills last, or every point); shuffled, the same points
    minus none."""
    radii, ks = [0.5, 1.0], [16, 32]
    for kind, most in (("sorted", 0.25), ("shuffled", 1.0)):
        xyz = _lidar(rng, 2, 2048, "sorted")
        new_xyz = _queries(rng, xyz, 512)
        if kind == "shuffled":
            xyz = np.ascontiguousarray(xyz[:, rng.permutation(2048)])
        _, tested, _ = emulate_ball_query(radii, ks, t(xyz), t(new_xyz))
        d2 = pairwise_sqdist(t(new_xyz), t(xyz))
        reach = None
        for r, k in zip(radii, ks):
            cum = torch.cumsum(d2 < radius_sq(r, "cpu"), -1)
            pos = torch.searchsorted(cum, torch.full_like(cum[..., :1],
                                                          k))[..., 0] + 1
            pos = torch.where(cum[..., -1] >= k, pos, 2048)
            reach = pos if reach is None else torch.maximum(reach, pos)
        ratio = float(tested.sum()) / float(reach.sum())
        assert ratio <= most, (kind, ratio)
        if kind == "shuffled":
            assert ratio > 0.5


# ------------------------------------------------------------- kernel 4
@pytest.mark.parametrize("qpt", [1, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_three_nn_emulation_matches_plain(rng, kind, qpt):
    """n = 1,000 unknown over m = 300 known points (neither a multiple of
    the chunk or the block): the emulated search equals three_nn_plain (d2
    and indices exactly), and its weighted rows equal
    three_interpolate_plain bit for bit."""
    unknown = _cloud(rng, 2, 1000, kind)
    known = _cloud(rng, 2, 300, kind)
    known[:, 40] = known[:, 250]                # an exact tie across chunks
    feats = rng.randn(2, 300, 8).astype(np.float32)
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), qpt)
    rd2, ridx = three_nn_plain(t(unknown), t(known))
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    assert torch.equal(_weighted_rows(t(feats), d2, idx),
                       three_interpolate_plain(t(unknown), t(known),
                                               t(feats)))


@pytest.mark.parametrize("kind", KINDS)
def test_three_nn_emulation_matches_jax(rng, kind):
    """The same against three_nn_pallas and three_interpolate_pallas
    (interpret mode; indices exact, d2 within 1e-6 relative, the bf16
    interpolation within 2e-2) and the JAX XLA path (indices and d2 exact,
    the interpolation within 1e-4)."""
    unknown = _cloud(rng, 2, 256, kind, spread=2.0)
    known = _cloud(rng, 2, 128, kind, spread=2.0)
    feats = rng.randn(2, 128, 16).astype(np.float32)
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), 1)
    ju, jk, jf = (jnp.asarray(a) for a in (unknown, known, feats))
    pd2, pidx = three_nn_pallas(ju, jk, interpret=True)
    np.testing.assert_array_equal(n(idx), np.asarray(pidx))
    np.testing.assert_allclose(n(d2), np.asarray(pd2), rtol=1e-6, atol=0)
    xd2, xidx = _three_nn_chunk(ju, jk)
    np.testing.assert_array_equal(n(idx), np.asarray(xidx))
    np.testing.assert_array_equal(n(d2), np.asarray(xd2))
    out = n(_weighted_rows(t(feats), d2, idx))
    np.testing.assert_allclose(out, np.asarray(three_interpolate_pallas(
        ju, jk, jf, interpret=True)), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(out, np.asarray(_interpolate_xla(
        ju, jk, jf, force_xla_nn=True)), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("m", [1, 2])
def test_three_nn_emulation_few_known_points(rng, m):
    """m < 3 repeats the nearest, as the plain version and JAX's XLA path."""
    unknown = _cloud(rng, 2, 300, "sorted")
    known = _cloud(rng, 2, m, "sorted")
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), 2)
    rd2, ridx = three_nn_plain(t(unknown), t(known))
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    xd2, xidx = _three_nn_chunk(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(n(idx), np.asarray(xidx))


def test_three_nn_equal_third_best_is_not_skipped():
    """A chunk whose z term equals the current third-best d2 can still hold
    a neighbour that wins its tie by a lower index: the strict > test
    keeps it. The query at z 0.5 sits in chunk 1's z range (home), whose
    points 41-43 lie at d2 1; chunk 0's nearest end, point 31, lies at
    d2 1 too, with z term 1: it must displace point 43."""
    known = np.zeros((1, 64, 3), np.float32)
    known[0, :31, 2] = -20.0
    known[0, 31, 2] = -0.5
    known[0, 32:41] = (100.0, 0.0, 0.25)
    known[0, 41:44, 2] = 1.5
    known[0, 44:, 2] = 20.0
    unknown = np.array([[[0.0, 0.0, 0.5]]], np.float32)
    lo, hi = chunk_bounds(t(known))
    assert _home(torch.tensor(0.5), torch.tensor(0.5), lo[0], hi[0]) == 1
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), 1)
    rd2, ridx = three_nn_plain(t(unknown), t(known))
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    assert idx[0, 0].tolist() == [31, 41, 42]


def test_three_nn_tests_fewer_pairs_on_sorted_clouds(rng):
    """On a z-sorted LiDAR-like scene (FP0 cut to 2,048 unknown and every
    fourth a known point) the pruned search tests a fraction of the n * m
    pairs of the dense scan; shuffled, it tests them all."""
    for kind, most in (("sorted", 0.35), ("shuffled", 1.0)):
        unknown = _lidar(rng, 2, 2048, "sorted")
        known = _queries(rng, unknown, 512)
        if kind == "shuffled":
            unknown = np.ascontiguousarray(unknown[:, rng.permutation(2048)])
            known = np.ascontiguousarray(known[:, rng.permutation(512)])
        _, _, pairs = emulate_three_nn(t(unknown), t(known), 4)
        ratio = pairs / (2 * 2048 * 512)
        assert ratio <= most, (kind, ratio)
        if kind == "shuffled":
            assert ratio == 1.0


def test_chunk_bounds_leave_nan_out():
    pts = torch.zeros((1, 70, 3))
    pts[0, :, 2] = torch.arange(70, dtype=torch.float32)
    pts[0, 3, 2] = float("nan")
    pts[0, 64:, 2] = float("nan")
    lo, hi = chunk_bounds(pts)
    assert lo.tolist() == [[0.0, 32.0, INF]]
    assert hi.tolist() == [[31.0, 63.0, -INF]]
    assert math.isinf(float(zterm(torch.tensor(5.0), lo[0, 2], hi[0, 2])))
