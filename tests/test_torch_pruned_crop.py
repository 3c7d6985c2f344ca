"""The cylinder crop-gather of kernels 5 and 10 (csrc/crop_gather.cu)
emulated in plain PyTorch, rule for rule as crop_gather_kernel and
listed_rank_search (csrc/search.cuh) apply them: 32-point chunks and their
z ranges; a centre listing, in windows of warps * 32 chunks, the chunks
whose z term from it is below r2 and testing them in rounds, kU list
entries a warp, ranking each member by the running count, the counts of
the round's earlier warps and its own earlier chunks, never stopping
early; the first min(cnt, k) members kept; each slot mapped to its member
by the kernel's integer arithmetic (grouped, or s % cnt) and the channels
gathered. Kernel 10 first finds its candidate range [lo, hi) by three
binary searches run five levels a round as warp_search does (31 lanes
each testing one node's mid, a walk on the ballot), falls back to all N
when the range spans more than z_window 128-point tiles, and then runs
kernel 5's search over the chunks that meet the range, the points outside
it masked. Each emulation must give exactly the output of the plain
versions (crop_gather_plain, crop_gather_window_plain) and of
crop_gather_pallas in interpret mode, on sorted, shuffled, clustered and
equal-z clouds, points at exactly r2, NaN z in points and centres, empty,
overfull and 3-member crops (k % 3 != 0) and centres in score order; every
member must lie in a chunk its centre lists, warp_search must find the
serial search's index on any predicate, and on sorted clouds the
emulation must test fewer points than the dense scan."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pruned_search import (KINDS, _cloud, _lidar, chunk_bounds,
                                      zterm)
from torch_port_helpers import n, t
from ws3d_tpu.ops.ball_query_pallas import crop_gather_pallas
from ws3d_tpu_torch.ops import crop_gather as cg
from ws3d_tpu_torch.ops._kernels import CHUNK
from ws3d_tpu_torch.ops.grouping import radius_sq

CROP_WARPS = 8        # csrc/crop_gather.cu: kCropWarps
CROP_ROUND = 8        # csrc/crop_gather.cu: kCropRound


def warp_search(a, e, left):
    """warp_search: the serial binary search (left(mid): e = mid, else
    a = mid + 1), five levels a round; -> (its a, rounds)."""
    rounds = 0
    while a < e:
        rounds += 1
        ballot = 0
        for lane in range(31):            # lane l: heap node l + 1
            node = lane + 1
            na, ne = a, e
            for s in range(node.bit_length() - 2, -1, -1):
                mid = (na + ne) >> 1
                if (node >> s) & 1:
                    na = mid + 1
                else:
                    ne = mid
            if na < ne and left((na + ne) >> 1):
                ballot |= 1 << lane
        node = 1
        for _ in range(5):
            if a >= e:
                break
            mid = (a + e) >> 1
            if ballot >> (node - 1) & 1:
                e, node = mid, 2 * node
            else:
                a, node = mid + 1, 2 * node + 1
    return a, rounds


def serial_search(a, e, left):
    while a < e:
        mid = (a + e) >> 1
        if left(mid):
            e = mid
        else:
            a = mid + 1
    return a


def window_range(pz, cz, r2):
    """Kernel 10's candidate range of one centre: pz (N,) and cz, r2
    np.float32 -> (lo, hi, rounds of its three searches)."""
    N = pz.shape[0]

    def near(j):
        dz = cz - pz[j]
        return bool(dz * dz < r2)
    home, r0 = warp_search(0, N, lambda j: bool(pz[j] >= cz))
    lo, r1 = warp_search(0, home, near)
    hi, r2_ = warp_search(home, N, lambda j: not near(j))
    return lo, hi, r0 + max(r1, r2_)


def listed_rank_search(c0, c1, need, member, cap, warps, kU):
    """listed_rank_search over chunks [c0, c1): need (nch,) bool, member
    (nch, CHUNK) bool -> (the first `cap` members' indices, the count, the
    listed chunks)."""
    kT = warps * 32
    members = np.full(cap, -1)
    running = 0
    listed = []
    for w0 in range(c0, c1, kT):
        lst = [c for c in range(w0, min(w0 + kT, c1)) if need[c]]
        listed += lst
        L = len(lst)
        for e0 in range(0, L, warps * kU):
            hit = [[member[lst[e]] if e < L else np.zeros(CHUNK, bool)
                    for e in range(e0 + w * kU, e0 + (w + 1) * kU)]
                   for w in range(warps)]
            counts = [sum(int(h.sum()) for h in hw) for hw in hit]
            for w in range(warps):
                rank = running + sum(counts[:w])
                for u in range(kU):
                    h = hit[w][u]
                    for lane in np.flatnonzero(h):
                        r = rank + int(h[:lane].sum())
                        if r < cap:
                            members[r] = lst[e0 + w * kU + u] * CHUNK + lane
                    rank += int(h.sum())
            running += sum(counts)
    return members, running, listed


def emulate_crop(xyz, ch, centers, radius, k, grouped, z_window=None,
                 warps=CROP_WARPS, kU=CROP_ROUND):
    """Kernel 5 (z_window None) or 10: -> (vals (C, B, M, k), cnt (B, M)
    int32, points tested a centre (B, M)). Asserts that every member lies
    in a chunk its centre lists."""
    B, N, _ = xyz.shape
    C, M = ch.shape[1], centers.shape[1]
    nch = -(-N // CHUNK)
    r2 = radius_sq(radius, "cpu")
    zlo, zhi = chunk_bounds(xyz)                                # (B, nch)
    dx = centers[..., 0:1] - xyz[:, None, :, 0]
    dz = centers[..., 1:2] - xyz[:, None, :, 2]
    d2 = dx * dx + dz * dz                                      # (B, M, N)
    size = np.minimum(CHUNK, N - CHUNK * np.arange(nch))
    vals = torch.zeros((C, B, M, k))
    cnt = torch.zeros((B, M), dtype=torch.int32)
    tested = torch.zeros((B, M), dtype=torch.long)
    pz = n(xyz[..., 2])
    for b in range(B):
        for m in range(M):
            cx, cz = centers[b, m, 0], centers[b, m, 1]
            lo, hi = 0, N
            if z_window is not None:
                wlo, whi, _ = window_range(pz[b], np.float32(cz),
                                           np.float32(r2))
                tiles = ((whi - 1) // cg.TILE - wlo // cg.TILE + 1
                         if whi > wlo else 0)
                if tiles <= z_window:
                    lo, hi = wlo, whi
            pos = torch.arange(nch * CHUNK)
            row = torch.full((nch * CHUNK,), float("inf"))
            row[:N] = d2[b, m]
            mem = ((pos >= lo) & (pos < hi) & (row < r2)).view(nch, CHUNK)
            need = n(zterm(cz, zlo[b], zhi[b]) < r2)
            c0 = lo // CHUNK
            c1 = -(-hi // CHUNK) if hi > lo else c0
            first, c, listed = listed_rank_search(c0, c1, need, n(mem), k,
                                                  warps, kU)
            unlisted = np.ones(nch, bool)
            unlisted[listed] = False
            assert not n(mem)[unlisted].any()
            assert c == int(mem.sum())
            tested[b, m] = int(size[listed].sum())
            cnt[b, m] = c
            if c == 0:
                continue
            Q, R = k // c, k % c
            thresh = R * (Q + 1)
            for s in range(k):
                if c >= k:
                    j = s
                elif grouped:
                    j = s // (Q + 1) if s < thresh else R + (s - thresh) // Q
                else:
                    j = s % c
                vals[:, b, m, s] = ch[b, :, first[j]]
    return vals, cnt, tested


# ------------------------------------------------------------------ inputs
def _crop_scene(rng, B, N, M, kind, radius, spread=4.0):
    """A cloud of a kind ("lidar": LiDAR-like, sorted), 4 channels (x, y, z
    and a random one) and M centres (x, z) drawn from the points in a
    random order (the proposals' score order): the first far off (an empty
    crop), the second on the point with the most neighbours within
    `radius` (an overfull crop), the third on three isolated points at z
    -100 (indices 0-2, which keeps a sorted cloud sorted: 3 members)."""
    xyz = (_lidar(rng, B, N, "sorted") if kind == "lidar"
           else _cloud(rng, B, N, kind, spread=spread))
    xyz[:, :3] = [(0.0, 0.0, -100.0), (0.1, 0.0, -100.0), (0.2, 0.0, -100.0)]
    pick = np.stack([rng.permutation(np.arange(3, N))[:M] for _ in range(B)])
    c = xyz[np.arange(B)[:, None], pick][..., [0, 2]]
    bev = xyz[..., [0, 2]]
    near = ((bev[:, :, None] - bev[:, None]) ** 2).sum(-1) < radius ** 2
    c[:, 0] = (500.0, 500.0)
    c[:, 1] = bev[np.arange(B), near.sum(-1).argmax(-1)]
    c[:, 2] = (0.0, -100.0)
    ch = np.concatenate([xyz.transpose(0, 2, 1),
                         rng.rand(B, 1, N).astype(np.float32)], axis=1)
    return (np.ascontiguousarray(xyz), np.ascontiguousarray(ch),
            np.ascontiguousarray(c, dtype=np.float32))


def _pallas(xyz, ch, c, radius, k, grouped, z_window=None):
    vals, cnt = crop_gather_pallas(
        jnp.asarray(xyz), jnp.asarray(ch), jnp.asarray(c), radius, k,
        grouped=grouped, interpret=True, z_window=z_window,
        center_z=None if z_window is None else jnp.asarray(c[..., 1]))
    return np.stack([np.asarray(v) for v in vals]), np.asarray(cnt)


def _same(got, ref):
    assert torch.equal(got[1], ref[1])
    assert torch.equal(got[0], ref[0])


# ---------------------------------------------------------------- kernel 5
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("kind", KINDS + ["lidar"])
def test_crop_emulation_matches_plain(rng, kind, grouped):
    """N = 2,000 (not a multiple of the chunk), 16 centres in score order
    with an empty, an overfull (cnt > k) and a 3-member crop (k % 3 != 0):
    the emulated kernel 5 equals crop_gather_plain, and kernel 10 at
    z_window 32 and 1 equals crop_gather_window_plain (and kernel 5 where
    the cloud is sorted)."""
    radius = 4.0 if kind == "lidar" else 2.0
    xyz, ch, c = (t(a) for a in _crop_scene(rng, 2, 2000, 16, kind,
                                            radius))
    got = emulate_crop(xyz, ch, c, radius, 128, grouped)
    _same(got[:2], cg.crop_gather_plain(xyz, ch, c, radius, 128, grouped))
    cnt = got[1]
    assert int(cnt[:, 0].max()) == 0 and bool((cnt[:, 1] > 128).all())
    assert bool((cnt[:, 2] == 3).all())
    for W in (32, 1):
        win = emulate_crop(xyz, ch, c, radius, 128, grouped, W)
        _same(win[:2], cg.crop_gather_window_plain(xyz, ch, c, radius, 128,
                                                   grouped, W))
        if kind != "shuffled":
            _same(win[:2], got[:2])


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_crop_emulation_matches_pallas(rng, kind, grouped):
    """At crop_gather_pallas's tiling (N 1,024, M 8, k 64): the emulated
    kernel 5 equals the Pallas kernel in interpret mode, and where the
    cloud is sorted so does kernel 10 at z_window 4 against its z-window
    mode."""
    xyz, ch, c = _crop_scene(rng, 2, 1024, 8, kind, 2.0)
    got = emulate_crop(t(xyz), t(ch), t(c), 2.0, 64, grouped)
    pv, pc = _pallas(xyz, ch, c, 2.0, 64, grouped)
    np.testing.assert_array_equal(n(got[1]), pc)
    np.testing.assert_array_equal(n(got[0]), pv)
    if kind != "shuffled":
        win = emulate_crop(t(xyz), t(ch), t(c), 2.0, 64, grouped, 4)
        pv, pc = _pallas(xyz, ch, c, 2.0, 64, grouped, 4)
        np.testing.assert_array_equal(n(win[1]), pc)
        np.testing.assert_array_equal(n(win[0]), pv)


def test_crop_points_at_exactly_r2(rng):
    """z on a 1/64 grid, so differences and squares are exact: points whose
    BEV d2 is exactly r2 (0.25: dz or dx 0.5) are outside the crop, and a
    chunk whose nearer end lies 0.5 from a centre in z (z term exactly r2)
    is not listed: the emulation equals both plain versions and the Pallas
    kernel."""
    N = 256
    xyz = rng.uniform(-0.05, 0.05, (1, N - 5, 3)).astype(np.float32)
    xyz[..., 2] = np.round(np.linspace(-3, 3, N - 5) * 64) / 64
    edge = np.array([[0.0, 0.0, 0.5], [0.0, 0.0, -0.5], [0.5, 0.0, 0.0],
                     [0.0, 0.0, 1.5], [0.0, 0.0, 0.5]], np.float32)
    xyz = np.concatenate([xyz, edge[None]], axis=1)
    xyz = np.ascontiguousarray(xyz[:, np.argsort(xyz[0, :, 2],
                                                 kind="stable")])
    ch = np.ascontiguousarray(xyz.transpose(0, 2, 1))
    c = np.zeros((1, 8, 2), np.float32)
    c[0, 1] = (0.0, 1.0)
    c[0, 2] = (0.0, xyz[0, 4 * CHUNK + CHUNK - 1, 2] + 0.5)
    d2 = (c[0, :, None, 0] - xyz[0, None, :, 0]) ** 2 + \
        (c[0, :, None, 1] - xyz[0, None, :, 2]) ** 2
    assert (d2 == np.float32(0.25)).sum() >= 4
    zlo, zhi = chunk_bounds(t(xyz))
    r2 = radius_sq(0.5, "cpu")
    assert float(zterm(t(c)[0, 2, 1], zlo[0, 4], zhi[0, 4])) == float(r2)
    for grouped in (True, False):
        got = emulate_crop(t(xyz), t(ch), t(c), 0.5, 64, grouped)
        _same(got[:2], cg.crop_gather_plain(t(xyz), t(ch), t(c), 0.5, 64,
                                            grouped))
        pv, pc = _pallas(xyz, ch, c, 0.5, 64, grouped)
        np.testing.assert_array_equal(n(got[1]), pc)
        np.testing.assert_array_equal(n(got[0]), pv)
        win = emulate_crop(t(xyz), t(ch), t(c), 0.5, 64, grouped, 1)
        _same(win[:2], got[:2])
        _same(win[:2], cg.crop_gather_window_plain(t(xyz), t(ch), t(c), 0.5,
                                                   64, grouped, 1))


@pytest.mark.parametrize("kind", ["sorted", "shuffled"])
def test_crop_nan_z(rng, kind):
    """NaN z in a whole chunk and mixed with finite points, and a centre
    with NaN z: NaN points are never members, the NaN centre's crop is
    empty, and the emulation of both kernels equals the plain versions
    (kernel 10's searches meet NaN as torch.searchsorted does) and kernel
    5's equals the Pallas kernel."""
    xyz, ch, c = _crop_scene(rng, 2, 1024, 8, kind, 2.0)
    xyz[:, 64:96, 2] = np.nan                     # a whole chunk
    xyz[:, 200:260:3, 2] = np.nan                 # mixed
    c[:, 4, 1] = np.nan
    args = (t(xyz), t(ch), t(c), 2.0, 64, True)
    got = emulate_crop(*args)
    _same(got[:2], cg.crop_gather_plain(*args))
    assert int(got[1][:, 4].max()) == 0
    pv, pc = _pallas(xyz, ch, c, 2.0, 64, True)
    np.testing.assert_array_equal(n(got[1]), pc)
    np.testing.assert_array_equal(n(got[0]), pv)
    for W in (32, 1):
        win = emulate_crop(*args, W)
        _same(win[:2], cg.crop_gather_window_plain(*args, W))


@pytest.mark.parametrize("warps,kU", [(1, 1), (4, 2), (16, 4)])
def test_crop_sizings_agree(rng, warps, kU):
    """The ranks do not depend on the sizing: with 1 warp (windows of 32
    chunks, so a centre's listing spans several), and with the bench's
    smallest and largest rounds, the emulation equals the plain
    version."""
    xyz, ch, c = (t(a) for a in _crop_scene(rng, 2, 2048, 8, "lidar",
                                            4.0))
    for grouped in (True, False):
        got = emulate_crop(xyz, ch, c, 4.0, 128, grouped, None, warps, kU)
        _same(got[:2], cg.crop_gather_plain(xyz, ch, c, 4.0, 128, grouped))


def test_crop_tests_fewer_points_on_sorted_clouds(rng):
    """At the inference path's radius (4 m) on a z-sorted LiDAR-like scene
    of 2,048 points, the listed search tests a fraction of the points a
    centre that the dense scan tests; shuffled, where every chunk spans
    most of the scene's depth, nearly all of them."""
    ratios = {}
    for kind in ("sorted", "shuffled"):
        xyz, ch, c = _crop_scene(rng, 2, 2048, 16, "lidar", 4.0)
        if kind == "shuffled":
            xyz = np.ascontiguousarray(xyz[:, rng.permutation(2048)])
        _, _, tested = emulate_crop(t(xyz), t(ch), t(c), 4.0, 128, True)
        live = torch.ones_like(tested, dtype=torch.bool)
        live[:, [0, 2]] = False          # the isolated centres list few
        ratios[kind] = float(tested[live].sum()) / (int(live.sum()) * 2048)
    assert ratios["sorted"] <= 0.35, ratios
    assert ratios["shuffled"] >= 0.9, ratios


# --------------------------------------------------------------- kernel 10
@pytest.mark.parametrize("kind", KINDS)
def test_warp_search_is_the_serial_search(rng, kind):
    """Five levels a round, warp_search finds the serial binary search's
    index for any predicate (a z-sorted cloud's, a shuffled one's, NaN
    z), in at most ceil(bits / 5) rounds a search; kernel 10's ranges
    equal z_windows' (torch.searchsorted and the plain binary searches)."""
    xyz, _, c = _crop_scene(rng, 2, 2000, 16, kind, 2.0)
    xyz[:, 500:520:2, 2] = np.nan
    c[:, 5, 1] = np.nan
    r2 = radius_sq(2.0, "cpu")
    lo, hi = cg.z_windows(t(xyz[..., 2]), t(c[..., 1]), r2)
    r2 = np.float32(r2)
    for b in range(2):
        pz = xyz[b, :, 2]
        for m in range(16):
            cz = c[b, m, 1]
            wlo, whi, rounds = window_range(pz, cz, r2)
            assert (wlo, whi) == (int(lo[b, m]), int(hi[b, m]))
            assert rounds <= 2 * 3                 # 2,000 < 2^15
            for left in (lambda j: bool(pz[j] >= cz),
                         lambda j: bool(pz[j] < cz),
                         lambda j: (j * 7919) % 3 == 0):
                for a, e in ((0, 2000), (17, 1234), (999, 1000), (5, 5)):
                    assert warp_search(a, e, left)[0] == \
                        serial_search(a, e, left)


@pytest.mark.parametrize("z_window", [1, 2, 32])
def test_window_ranges_across_chunks_and_tiles(rng, z_window):
    """On a z-sorted cloud of 2,048 points: ranges that start and end
    inside chunks (a centre's range straddles chunk borders), ranges of
    one tile and ranges over the budget (searched over all N): the
    emulated kernel 10 equals crop_gather_window_plain and kernel 5, and
    at z_window 1 some centres fall back while others do not."""
    xyz, ch, c = _crop_scene(rng, 2, 2048, 16, "sorted", 1.0,
                             spread=8.0)
    c[:, 3:6, 1] = xyz[:, [300, 1000, 1700], 2] + 0.013    # mid-chunk z
    args = (t(xyz), t(ch), t(c), 1.0, 96, True)
    r2 = radius_sq(1.0, "cpu")
    lo, hi = cg.z_windows(args[0][..., 2], args[2][..., 1], r2)
    assert bool(((lo % CHUNK != 0) & (hi % CHUNK != 0)).any())
    tiles = cg.window_tiles(lo, hi)
    win = emulate_crop(*args, z_window)
    _same(win[:2], cg.crop_gather_window_plain(*args, z_window))
    _same(win[:2], cg.crop_gather_plain(*args))
    if z_window == 1:
        assert bool((tiles == 1).any()) and bool((tiles > 1).any())
