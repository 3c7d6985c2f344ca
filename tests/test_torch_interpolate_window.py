"""Kernel 8 (the windowed 3-NN interpolation for z-sorted clouds) on the
CPU: the port's plain version, which runs a window search with its own stop
rule, against three_interpolate_window_pallas in interpret mode (2e-2: the
TPU kernel multiplies in bf16), against the JAX XLA composition (1e-5) and
the port's full 3-NN (indices equal); the kernel's own search, kernel 4's
staged search emulated rule for rule (tests/test_torch_pruned_search.py) on
each chunk's first and last z as kernel 8 reads them, against the plain
version's on sorted clouds with ties, equal z and m < 3, and what it
returns on unsorted clouds; PointnetFPModule with sorted_points against
the JAX module (1e-5)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from test_torch_pruned_search import chunk_bounds, emulate_three_nn
from torch_port_helpers import n, t
from ws3d_tpu.models.pointnet2 import PointnetFPModule as JaxFP
from ws3d_tpu.ops.interpolate import _interpolate_xla
from ws3d_tpu.ops.three_nn_pallas import three_interpolate_window_pallas
from ws3d_tpu_torch.models.pointnet2 import PointnetFPModule
from ws3d_tpu_torch.ops.interpolate import (interpolate_features,
                                            three_interpolate_plain,
                                            three_interpolate_window_plain,
                                            three_nn_plain,
                                            three_nn_window_plain,
                                            window_search)
from ws3d_tpu_torch.weights import load_flat


def _sorted_pair(rng, B, n_, m, C, spread=3.0, cluster=False):
    """tests/test_point_ops.py's z-sorted pairs."""
    unknown = rng.randn(B, n_, 3).astype(np.float32) * spread
    known = rng.randn(B, m, 3).astype(np.float32) * spread
    if cluster:
        known[:, : m // 2, 2] = rng.randn(B, m // 2).astype(np.float32) * 0.2
        unknown[:, : n_ // 2, 2] = rng.randn(B, n_ // 2).astype(
            np.float32) * 0.2
    unknown = unknown[np.arange(B)[:, None],
                      np.argsort(unknown[..., 2], axis=1)]
    known = known[np.arange(B)[:, None], np.argsort(known[..., 2], axis=1)]
    return unknown, known, rng.randn(B, m, C).astype(np.float32)


def _cases(rng):
    far = _sorted_pair(rng, 1, 64, 256, 8)
    far[0][..., 2] += 30.0                        # all beyond the known z
    return {"unclustered": _sorted_pair(rng, 2, 256, 512, 16),
            "clustered": _sorted_pair(rng, 2, 256, 512, 16, cluster=True),
            "far": far}


@pytest.mark.parametrize("case", ["unclustered", "clustered", "far"])
def test_window_plain_matches_jax(rng, case):
    unknown, known, feats = _cases(rng)[case]
    got = n(three_interpolate_window_plain(t(unknown), t(known), t(feats)))
    pallas = np.asarray(three_interpolate_window_pallas(
        jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats),
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-2, atol=2e-2)
    xla = np.asarray(_interpolate_xla(jnp.asarray(unknown),
                                      jnp.asarray(known), jnp.asarray(feats),
                                      force_xla_nn=True))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)
    d2, idx = three_nn_window_plain(t(unknown), t(known))
    rd2, ridx = three_nn_plain(t(unknown), t(known))
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)
    assert torch.equal(torch.from_numpy(got), three_interpolate_plain(
        t(unknown), t(known), t(feats)))


def chunk_ends(known):
    """(lo, hi), each (B, chunks): each 32-point chunk's first and last z,
    the chunk bounds kernel 8 reads in place."""
    B, m, _ = known.shape
    nch = -(-m // 32)
    first = torch.arange(nch) * 32
    last = torch.clamp(first + 31, max=m - 1)
    return known[:, first, 2], known[:, last, 2]


@pytest.mark.parametrize("case", ["unclustered", "clustered", "far",
                                  "tie", "equal_z"])
def test_kernel_search_matches_window_search(rng, case):
    """Kernel 8 runs kernel 4's staged search (one query a thread, as the
    library launches it) on each chunk's first and last z: on sorted clouds
    those are the pre-pass's bounds, and its neighbours are the plain
    version's window search's, d2 and indices exactly, with an exact tie
    across chunks and with duplicate z (every z rounded to 0.5)."""
    if case in ("tie", "equal_z"):
        unknown, known, _ = _sorted_pair(rng, 2, 300, 200, 1)
        if case == "tie":
            known[:, 150] = known[:, 10]
            known[:, 149] = known[:, 10]
            known = known[np.arange(2)[:, None],
                          np.argsort(known[..., 2], axis=1, kind="stable")]
        else:
            known[..., 2] = np.round(known[..., 2] * 2.0) * 0.5
            unknown[..., 2] = np.round(unknown[..., 2] * 2.0) * 0.5
    else:
        unknown, known, _ = _cases(rng)[case]
    ends = chunk_ends(t(known))
    for a, b in zip(ends, chunk_bounds(t(known))):
        assert torch.equal(a, b)
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), 1, bounds=ends)
    wd2, widx = three_nn_window_plain(t(unknown), t(known))
    assert torch.equal(idx, widx) and torch.equal(d2, wd2)


@pytest.mark.parametrize("m", [1, 2, 3])
def test_kernel_search_few_known_points(rng, m):
    """m < 3: the kernel's search repeats the nearest as the window search
    does; m = 3 with two equal points ties by index."""
    unknown, known, _ = _sorted_pair(rng, 2, 200, m, 1)
    if m == 3:
        known[:, 1] = known[:, 0]
    d2, idx, _ = emulate_three_nn(t(unknown), t(known), 1,
                                  bounds=chunk_ends(t(known)))
    wd2, widx = three_nn_window_plain(t(unknown), t(known))
    assert torch.equal(idx, widx) and torch.equal(d2, wd2)


def test_kernel_search_on_unsorted_clouds(rng):
    """What kernel 8 returns where the known points are not sorted by z:
    the first and last z of a chunk bound nothing, so the search skips
    chunks that hold neighbours. Each query still gets three distinct known
    points in (d2, index) order with their exact d2, each no nearer than
    the true neighbour of its rank (three_nn_plain), and on this cloud not
    always the true ones."""
    unknown, known, _ = _sorted_pair(rng, 2, 256, 512, 1)
    known = np.ascontiguousarray(known[:, rng.permutation(512)])
    u, k = t(unknown), t(known)
    d2, idx, _ = emulate_three_nn(u, k, 1, bounds=chunk_ends(k))
    rd2, ridx = three_nn_plain(u, k)
    pts = torch.gather(k, 1, idx.long().reshape(2, -1, 1).expand(
        -1, -1, 3)).reshape(2, 256, 3, 3)
    dd = u[:, :, None] - pts
    assert torch.equal(d2, (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1])
                       + dd[..., 2] * dd[..., 2])
    assert bool(((d2[..., :2] < d2[..., 1:])
                 | ((d2[..., :2] == d2[..., 1:])
                    & (idx[..., :2] < idx[..., 1:]))).all())
    assert bool((d2 >= rd2).all())
    assert not torch.equal(idx, ridx)


def test_window_visits_fewer_than_all(rng):
    unknown, known, _ = _sorted_pair(rng, 2, 512, 1024, 1, spread=5.0)
    _, _, visits = window_search(t(unknown), t(known))
    assert int(visits.min()) >= 3
    assert float(visits.float().mean()) < 0.5 * known.shape[1]


@pytest.mark.parametrize("m", [1, 2, 3])
def test_window_few_known_points(rng, m):
    """m < 3 repeats the nearest, ties go to the lower index."""
    unknown, known, feats = _sorted_pair(rng, 2, 40, m, 4)
    if m == 3:
        known[:, 1] = known[:, 0]
    d2, idx = three_nn_window_plain(t(unknown), t(known))
    rd2, ridx = three_nn_plain(t(unknown), t(known))
    assert torch.equal(idx, ridx) and torch.equal(d2, rd2)


def test_window_backward_is_the_full_one(rng):
    unknown, known, feats = _sorted_pair(rng, 2, 300, 128, 8)
    g = torch.from_numpy(rng.randn(2, 300, 8).astype(np.float32))
    grads = []
    for sorted_z in (True, False):
        f = t(feats).requires_grad_(True)
        (interpolate_features(t(unknown), t(known), f, sorted_z=sorted_z)
         * g).sum().backward()
        grads.append(f.grad)
    assert torch.equal(*grads)


@pytest.mark.parametrize("train", [False, True])
def test_fp_module_sorted_points_matches_jax(rng, train):
    B, n_, m, cu, ck, mlp = 2, 256, 64, 16, 32, [32, 24]
    unknown, known, known_feats = _sorted_pair(rng, B, n_, m, ck)
    unknown_feats = rng.randn(B, n_, cu).astype(np.float32)
    jmod = JaxFP(mlp=mlp, use_bn=True, sorted_points=True)
    jargs = [jnp.asarray(a) for a in (unknown, known, unknown_feats,
                                      known_feats)]
    variables = jmod.init(jax.random.PRNGKey(0), *jargs)
    flat = {"/".join(k): np.array(v)
            for k, v in flatten_dict(jax.tree.map(np.asarray,
                                                  dict(variables))).items()}
    for k in flat:                                # non-trivial BN and biases
        if k.endswith(("bias", "mean")):
            flat[k] = rng.randn(*flat[k].shape).astype(np.float32) * 0.1
        elif k.endswith(("scale", "var")):
            flat[k] = rng.uniform(0.5, 1.5, flat[k].shape).astype(np.float32)
    variables = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                for k, v in flat.items()})
    if train:
        ref, _ = jmod.apply(variables, *jargs, train=True,
                            mutable=["batch_stats"])
    else:
        ref = jmod.apply(variables, *jargs)
    port = PointnetFPModule(ck, cu, mlp, use_bn=True, sorted_points=True)
    load_flat(port, flat)
    got = port(t(unknown), t(known), t(unknown_feats), t(known_feats),
               train=train)
    ref = np.asarray(ref)
    np.testing.assert_allclose(n(got), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
