"""The pruned searches of kernels 7 (the 3-NN search of the interpolation
backward) and 6w (the wrap-pad ball query of the proposal database)
emulated in plain PyTorch, rule for rule as csrc/search.cuh
(staged_three_nn) and csrc/ball_query.cu (ball_query_wrap_kernel) apply
them. Kernel 7 runs kernel 4's staged search (emulate_three_nn of
test_torch_pruned_search.py at one query a thread) without the weights and
the gather. Kernel 6w: 32-point chunks and their z ranges, a centre
testing only the chunks whose z term from it is below r2, and the members
ranked in ascending index over the tested chunks, never stopping early;
the S slots take the (s % cnt)-th member. Each emulation must give the
plain version's output exactly (three_nn_plain, ball_query_wrap_plain)
and the JAX references' (the Pallas kernels in interpret mode and the XLA
paths), on z-sorted, shuffled, clustered and equal-z clouds, points at
exactly r2, m < 3, an equal third-best d2, empty and overfull balls,
invalid points moved FAR, NaN z and centres in score order; every in-ball
point must lie in a chunk its centre tests; and on sorted clouds the
emulated searches test fewer points than the dense scan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pruned_search import (KINDS, _cloud, _lidar, _queries,
                                      chunk_bounds, emulate_three_nn, zterm)
from torch_port_helpers import n, t
from ws3d_tpu.ops.ball_query_pallas import ball_query_pallas
from ws3d_tpu.ops.grouping import _pairwise_sqdist as jax_pairwise_sqdist
from ws3d_tpu.ops.interpolate import _three_nn_chunk
from ws3d_tpu.ops.roipool import _first_k_wraparound
from ws3d_tpu.ops.three_nn_pallas import three_nn_pallas
from ws3d_tpu_torch.ops._kernels import CHUNK
from ws3d_tpu_torch.ops.ball_query import ball_query_wrap_plain
from ws3d_tpu_torch.ops.grouping import pairwise_sqdist, radius_sq
from ws3d_tpu_torch.ops.interpolate import three_nn, three_nn_plain
from ws3d_tpu_torch.pipeline.inference import FAR

KERNEL7_QPT = 1          # csrc/three_nn.cu: launch_three_nn<1, ...>


def emulate_ball_query_wrap(radii, nsamples, xyz, new_xyz):
    """Kernel 6w: -> (per scale idx (B, M, S) int32, per scale counts
    (B, M) int32, points tested a centre (B, M) over the scales). Asserts
    that every in-ball point lies in a chunk its centre tests."""
    N = xyz.shape[1]
    lo, hi = chunk_bounds(xyz)                                  # (B, nch)
    d2 = pairwise_sqdist(new_xyz, xyz)                          # (B, M, N)
    qz = new_xyz[..., 2, None]
    # a centre tests the chunks whose z term from it is below r2
    term = zterm(qz, lo[:, None], hi[:, None])                  # (B, M, nch)
    chunk_of = torch.arange(N) // CHUNK
    size = torch.bincount(chunk_of)
    idx, cnt = [], []
    tested = torch.zeros(new_xyz.shape[:2], dtype=torch.long)
    for r, S in zip(radii, nsamples):
        r2 = radius_sq(r, "cpu")
        go = term < r2
        in_ball = d2 < r2
        member = in_ball & go[..., chunk_of]
        assert torch.equal(member, in_ball)
        tested += (go.long() * size).sum(-1)
        # ranks in ascending index; the first S members, then s % cnt
        rank = torch.cumsum(member.long(), -1) - 1
        c_s = member.sum(-1)
        first = torch.zeros(c_s.shape + (S + 1,), dtype=torch.long)
        first.scatter_(-1, torch.where(member & (rank < S), rank, S),
                       torch.arange(N).expand_as(rank).contiguous())
        slot = torch.arange(S) % torch.clamp(c_s, min=1)[..., None]
        row = torch.gather(first, -1, slot)
        idx.append(torch.where(c_s[..., None] > 0, row, 0).to(torch.int32))
        cnt.append(c_s.to(torch.int32))
    return tuple(idx), tuple(cnt), tested


# ------------------------------------------------------------------ inputs
def _bev(xyz, q):
    """y zeroed on both sides, as the database path's BEV crop."""
    xyz, q = xyz.copy(), q.copy()
    xyz[..., 1] = 0.0
    q[..., 1] = 0.0
    return np.ascontiguousarray(xyz), np.ascontiguousarray(q)


def _db_scene(rng, B, N, M, kind, n_far=0, spread=4.0):
    """Points of a kind (LiDAR-like for "lidar"), the last n_far (of the
    sorted cloud) moved FAR as invalid points are; M centres drawn from the
    valid points in a random order (the proposals' score order)."""
    xyz = (_lidar(rng, B, N, "sorted") if kind == "lidar"
           else _cloud(rng, B, N, "sorted" if kind == "shuffled" else kind,
                       spread=spread))
    if n_far:
        xyz[:, N - n_far:, 0] = FAR
        xyz[:, N - n_far:, 2] = FAR
    pick = np.stack([rng.permutation(N - n_far)[:M] for _ in range(B)])
    q = xyz[np.arange(B)[:, None], pick]
    if kind == "shuffled":
        xyz = xyz[np.arange(B)[:, None],
                  np.stack([rng.permutation(N) for _ in range(B)])]
    return _bev(xyz, q)


def _jax_wrap(radii, nsamples, xyz, q):
    """The JAX XLA path: _first_k_wraparound on the in-ball mask of
    _pairwise_sqdist, per row; -> (idx, counts) tuples as numpy."""
    d2 = np.asarray(jax_pairwise_sqdist(jnp.asarray(q), jnp.asarray(xyz)))
    idx, cnt = [], []
    for r, S in zip(radii, nsamples):
        mask = d2 < np.float32(r * r)
        idx.append(np.stack([np.asarray(_first_k_wraparound(
            jnp.asarray(m), S)[0]) for m in mask]))
        cnt.append(mask.sum(-1).astype(np.int32))
    return idx, cnt


# ------------------------------------------------------------- kernel 7
@pytest.mark.parametrize("kind", KINDS)
def test_three_nn_search_matches_plain(rng, kind):
    """At FP-level ratios (n = 4 m, every fourth point known, as the
    backbone's FP stages; neither a multiple of the chunk or the block)
    with an exact tie across chunks: kernel 7's emulated search equals
    three_nn_plain bit for bit (d2 and indices), which the CPU dispatch
    returns."""
    unknown = _cloud(rng, 2, 1300, kind)
    known = np.ascontiguousarray(_queries(rng, _cloud(rng, 2, 1300, kind),
                                          325))
    known[:, 17] = known[:, 300]
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), KERNEL7_QPT)
    rd2, ridx = three_nn_plain(t(unknown), t(known))
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    gd2, gidx = three_nn(t(unknown), t(known))
    assert torch.equal(gidx, ridx) and torch.equal(gd2, rd2)


@pytest.mark.parametrize("kind", KINDS)
def test_three_nn_search_matches_jax(rng, kind):
    """The same against three_nn_pallas (interpret mode; indices exact, d2
    within 1e-6 relative) and the JAX XLA path _three_nn_chunk (both
    exact), on a LiDAR-like cloud for "sorted"."""
    unknown = (_lidar(rng, 2, 512, "sorted") if kind == "sorted"
               else _cloud(rng, 2, 512, kind, spread=2.0))
    known = _queries(rng, unknown, 128)
    if kind == "shuffled":
        known = np.ascontiguousarray(known[:, rng.permutation(128)])
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), KERNEL7_QPT)
    ju, jk = jnp.asarray(unknown), jnp.asarray(known)
    pd2, pidx = three_nn_pallas(ju, jk, interpret=True)
    np.testing.assert_array_equal(n(idx), np.asarray(pidx))
    np.testing.assert_allclose(n(d2), np.asarray(pd2), rtol=1e-6, atol=0)
    xd2, xidx = _three_nn_chunk(ju, jk)
    np.testing.assert_array_equal(n(idx), np.asarray(xidx))
    np.testing.assert_array_equal(n(d2), np.asarray(xd2))


@pytest.mark.parametrize("m", [1, 2])
def test_three_nn_search_few_known_points(rng, m):
    """m < 3 repeats the nearest, as the plain version and both JAX
    paths."""
    unknown = _cloud(rng, 2, 200, "clusters")
    known = _cloud(rng, 2, m, "clusters")
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), KERNEL7_QPT)
    rd2, ridx = three_nn_plain(t(unknown), t(known))
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    ju, jk = jnp.asarray(unknown), jnp.asarray(known)
    xd2, xidx = _three_nn_chunk(ju, jk)
    np.testing.assert_array_equal(n(idx), np.asarray(xidx))
    np.testing.assert_array_equal(n(d2), np.asarray(xd2))


@pytest.mark.parametrize("side", ["below", "above"])
def test_three_nn_equal_third_best_on_either_side(side):
    """The third-best d2 ties between points of the home chunk and a point
    of a chunk visited later, lying below or above the query in z (an
    unsorted cloud for "above"): that point has the lowest index and must
    win, so its chunk, whose z term equals the third-best d2 once the home
    chunk is searched, is not skipped (strict >). The query sits at z 0;
    chunk 1 (z 0) holds points 40-42 at d2 1; chunk 0 lies at z -30 or
    +30 but for point 31 at z -1 or +1, at d2 1 too."""
    s = -1.0 if side == "below" else 1.0
    known = np.zeros((1, 96, 3), np.float32)
    known[0, :32, 2] = 30.0 * s
    known[0, 31, 2] = s
    known[0, 32:64] = (50.0, 0.0, 0.0)
    known[0, 64:, 2] = -30.0 * s
    known[0, 40] = (1.0, 0.0, 0.0)
    known[0, 41] = (-1.0, 0.0, 0.0)
    known[0, 42] = (0.0, 1.0, 0.0)
    unknown = np.zeros((1, 1, 3), np.float32)
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), KERNEL7_QPT)
    rd2, ridx = three_nn_plain(t(unknown), t(known))
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    assert idx[0, 0].tolist() == [31, 40, 41]
    np.testing.assert_array_equal(
        n(idx), np.asarray(_three_nn_chunk(jnp.asarray(unknown),
                                           jnp.asarray(known))[1]))


def test_three_nn_search_tests_fewer_pairs_on_sorted_clouds(rng):
    """At the stage-1 FP0 ratio cut to 2,048 unknown points (every fourth
    one known) on a z-sorted LiDAR-like scene, kernel 7's search tests a
    fraction of the n * m pairs of the dense scan; shuffled, all of
    them."""
    for kind, most in (("sorted", 0.35), ("shuffled", 1.0)):
        unknown = _lidar(rng, 2, 2048, "sorted")
        known = _queries(rng, unknown, 512)
        if kind == "shuffled":
            unknown = np.ascontiguousarray(unknown[:, rng.permutation(2048)])
            known = np.ascontiguousarray(known[:, rng.permutation(512)])
        _, _, pairs = emulate_three_nn(t(unknown), t(known), KERNEL7_QPT)
        ratio = pairs / (2 * 2048 * 512)
        assert ratio <= most, (kind, ratio)
        if kind == "shuffled":
            assert ratio == 1.0


# ------------------------------------------------------------ kernel 6w
@pytest.mark.parametrize("scales", ["one", "two"])
@pytest.mark.parametrize("kind", KINDS + ["lidar"])
def test_wrap_emulation_matches_plain(rng, kind, scales):
    """N = 2,000 (not a multiple of the chunk), 60 centres in score order,
    the last 150 points moved FAR, an empty ball, one of 3 members (s % 3)
    and an overfull one (cnt > S) in each row, one scale or two: the
    emulated pruned count scan equals ball_query_wrap_plain exactly."""
    xyz, q = _db_scene(rng, 2, 2000, 60, kind, n_far=150, spread=3.0)
    q[:, 5] = (0.0, 0.0, -40.0)                         # an empty ball
    q[:, 9] = xyz[:, int(np.argmin(np.abs(xyz[0, :, 2])))]
    xyz[:, :3] = [(0.0, 0.0, -20.0), (0.1, 0.0, -20.0), (0.2, 0.0, -20.0)]
    q[:, 11] = (0.0, 0.0, -20.0)                        # 3 members
    r = 4.0 if kind == "lidar" else 1.5
    radii, ks = ([r], [48]) if scales == "one" else ([0.5, r], [8, 40])
    got_i, got_c, _ = emulate_ball_query_wrap(radii, ks, t(xyz), t(q))
    ref_i, ref_c = ball_query_wrap_plain(radii, ks, t(xyz), t(q))
    for a, b in zip(got_i + got_c, ref_i + ref_c):
        assert torch.equal(a, b)
    c = got_c[-1]
    assert int(c[:, 5].max()) == 0 and not bool(got_i[-1][:, 5].any())
    assert bool((c > ks[-1]).any()) and bool((c[:, 11] == 3).all())


@pytest.mark.parametrize("kind", KINDS)
def test_wrap_emulation_matches_jax(rng, kind):
    """The same against ball_query_pallas(wrap_pad=True) in interpret mode
    and the JAX XLA path (_first_k_wraparound on _pairwise_sqdist's
    mask), at N = 512 and 64 centres in score order."""
    xyz, q = _db_scene(rng, 2, 512, 64, kind, n_far=40, spread=2.0)
    q[:, 3] = (50.0, 0.0, 50.0)                         # an empty ball
    radii, ks = [0.5, 1.5], [8, 64]
    got_i, got_c, _ = emulate_ball_query_wrap(radii, ks, t(xyz), t(q))
    p_i, p_c = ball_query_pallas(radii, ks, jnp.asarray(xyz), jnp.asarray(q),
                                 interpret=True, wrap_pad=True)
    x_i, x_c = _jax_wrap(radii, ks, xyz, q)
    for ref_i, ref_c in ((p_i, p_c), (x_i, x_c)):
        for a, b in zip(got_i + got_c, tuple(ref_i) + tuple(ref_c)):
            np.testing.assert_array_equal(n(a), np.asarray(b))


def test_wrap_points_at_exactly_r2(rng):
    """Points whose d2 is exactly r2 (0.25: dz = 0.5, or dx = 0.3 and
    dz = 0.4 in binary fractions that square exactly) are outside the
    ball, and a chunk whose z term is exactly r2 is skipped: the
    emulation still equals the plain version and the XLA path."""
    N = 256
    xyz = rng.uniform(-0.05, 0.05, (1, N, 3)).astype(np.float32)
    xyz[:, :, 2] += np.linspace(-3, 3, N, dtype=np.float32)
    edge = np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5], [0.5, 0.0, 0.0],
                     [0.0, 0.0, 1.5], [0.0, 0.0, 0.5]], np.float32)
    xyz = np.concatenate([xyz, edge[None]], axis=1)
    xyz = xyz[:, np.argsort(xyz[0, :, 2], kind="stable")]
    q = np.array([[[0.0, 0.0, 0.0], [0.0, 0.0, 1.0]]], np.float32)
    xyz, q = _bev(xyz, q)
    d2 = n(pairwise_sqdist(t(q), t(xyz)))
    assert (d2 == np.float32(0.25)).sum() >= 4
    got_i, got_c, _ = emulate_ball_query_wrap([0.5], [64], t(xyz), t(q))
    ref_i, ref_c = ball_query_wrap_plain([0.5], [64], t(xyz), t(q))
    assert torch.equal(got_i[0], ref_i[0]) and torch.equal(got_c[0],
                                                           ref_c[0])
    x_i, x_c = _jax_wrap([0.5], [64], xyz, q)
    np.testing.assert_array_equal(n(got_i[0]), x_i[0])
    np.testing.assert_array_equal(n(got_c[0]), x_c[0])
    for row, idx, c in zip(d2[0], n(got_i[0])[0], n(got_c[0])[0]):
        assert c == int((row < np.float32(0.25)).sum())
        assert not (row[idx[:c]] == np.float32(0.25)).any()


def test_wrap_nan_z_and_far_points(rng):
    """Points with NaN z (in a chunk of their own and mixed with finite
    ones), invalid points moved FAR and a centre with NaN z: NaN points
    are never members, a NaN centre's ball is empty, and the emulation
    equals the plain version."""
    xyz, q = _db_scene(rng, 2, 700, 24, "sorted", n_far=100, spread=2.0)
    xyz[:, 64:96, 2] = np.nan                     # a whole chunk
    xyz[:, 200:260:3, 2] = np.nan                 # mixed
    q[:, 4, 2] = np.nan
    got_i, got_c, _ = emulate_ball_query_wrap([1.0], [32], t(xyz), t(q))
    ref_i, ref_c = ball_query_wrap_plain([1.0], [32], t(xyz), t(q))
    assert torch.equal(got_i[0], ref_i[0])
    assert torch.equal(got_c[0], ref_c[0])
    assert int(got_c[0][:, 4].max()) == 0
    for b in range(2):
        c = n(got_c[0])[b]
        rows = n(got_i[0])[b][c > 0]
        assert not np.isnan(xyz[b, rows, 2]).any()
        assert (rows < 600).all()                 # no FAR point


def test_wrap_tests_fewer_points_on_sorted_clouds(rng):
    """At the database path's radius and order (r 4 m, centres in score
    order, a FAR tail) on a z-sorted LiDAR-like scene of 2,048 points, the
    pruned scan tests a fraction of the 2,048 points a centre that the
    dense scan tests; shuffled, all of them."""
    for kind, most in (("lidar", 0.35), ("shuffled", 1.0)):
        xyz, q = _db_scene(rng, 2, 2048, 64, "lidar", n_far=300)
        if kind == "shuffled":
            xyz = np.ascontiguousarray(xyz[:, rng.permutation(2048)])
        _, _, tested = emulate_ball_query_wrap([4.0], [256], t(xyz), t(q))
        ratio = float(tested.sum()) / (2 * 64 * 2048)
        assert ratio <= most, (kind, ratio)
        if kind == "shuffled":
            assert ratio == 1.0
