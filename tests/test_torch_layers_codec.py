"""Layers, the BN fold, the box codec, rotated IoU, the greedy sweep, the
proposal step and finalize, each against its JAX counterpart on the same
numpy inputs (f32; tolerances stated per test)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu import box_codec as jcodec
from ws3d_tpu.models import layers as jlayers
from ws3d_tpu.ops import boxes as jboxes
from ws3d_tpu.ops.iou3d import boxes_iou3d as jax_iou3d
from ws3d_tpu.ops.nms import _greedy_suppress
from ws3d_tpu.pipeline import inference as jinf
from ws3d_tpu_torch import box_codec as tcodec
from ws3d_tpu_torch.models.layers import HeadMLP, SharedMLP, folded_mlp_params
from ws3d_tpu_torch.ops import boxes as tboxes
from ws3d_tpu_torch.ops.iou3d import boxes_iou3d
from ws3d_tpu_torch.ops.nms import greedy_suppress
from ws3d_tpu_torch.pipeline import inference as tinf
from ws3d_tpu_torch.weights import load_flat


def _flat(variables):
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out["/".join(prefix + (k,))] = np.asarray(v)
    for coll in ("params", "batch_stats"):
        if coll in variables:
            walk(variables[coll], (coll,))
    return out


def _randomize(flat, rng):
    return {k: (rng.rand(*v.shape).astype(np.float32) + 0.5 if k.endswith(
        ("var", "scale")) else rng.randn(*v.shape).astype(np.float32) * 0.3)
        for k, v in flat.items()}


@pytest.mark.parametrize("use_bn", [True, False])
def test_shared_mlp_and_fold_match_flax(rng, use_bn):
    x = rng.randn(2, 5, 7, 6).astype(np.float32)
    jm = jlayers.SharedMLP([8, 12], use_bn=use_bn)
    flat = _randomize(_flat(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))),
                      rng)
    variables = {"params": {}, "batch_stats": {}}
    for k, v in flat.items():
        coll, *path = k.split("/")
        node = variables[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    tm = SharedMLP(6, [8, 12], use_bn=use_bn)
    load_flat(tm, {k: v for k, v in flat.items()})
    with torch.no_grad():
        np.testing.assert_allclose(n(tm(t(x))), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)
        h = t(x)
        for W, b in zip(*folded_mlp_params(tm)):
            h = torch.relu(h @ W + b)
    np.testing.assert_allclose(n(h), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_fold_cache_follows_the_weights(rng):
    """SharedMLP.folded()/packed() are made once per state of the weights:
    the same objects while nothing changes, a refold after load_flat or an
    in-place edit, and a fresh fold under autograd."""
    from ws3d_tpu_torch.ops.fused_sa import pack_params
    tm = SharedMLP(6, [8, 12])
    flat = {"params/" + k.replace(".", "/") if not k.endswith(("mean", "var"))
            else "batch_stats/" + k.replace(".", "/"): n(v)
            for k, v in tm.state_dict().items()}

    def same_as_uncached(fold, packed):
        ref = folded_mlp_params(tm)
        for a, b in zip(fold[0] + fold[1], ref[0] + ref[1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(packed, pack_params(*ref), rtol=0, atol=0)

    with torch.no_grad():
        fold, packed = tm.folded(), tm.packed()
        assert tm.folded() is fold and tm.packed() is packed
        load_flat(tm, _randomize(flat, rng))
        fold2, packed2 = tm.folded(), tm.packed()
        assert fold2 is not fold and packed2 is not packed
        same_as_uncached(fold2, packed2)
        tm.BatchNorm_1.var.mul_(2.0)
        fold3 = tm.folded()
        assert fold3 is not fold2
        same_as_uncached(fold3, tm.packed())
    assert tm.folded() is not tm.folded()
    assert tm.folded()[0][0].requires_grad


def test_head_mlp_matches_flax(rng):
    x = rng.randn(4, 16).astype(np.float32)
    jm = jlayers.HeadMLP([10], out_channels=3, use_bn=True, dp_ratio=0.5)
    flat = _randomize(_flat(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))),
                      rng)
    variables = {"params": {}, "batch_stats": {}}
    for k, v in flat.items():
        coll, *path = k.split("/")
        node = variables[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)
    ref = jm.apply(variables, jnp.asarray(x), train=False)
    tm = HeadMLP(16, [10], 3, use_bn=True)
    load_flat(tm, flat)
    with torch.no_grad():
        np.testing.assert_allclose(n(tm(t(x))), np.asarray(ref), atol=1e-5,
                                   rtol=1e-5)


def test_box_codec_matches_jax(rng):
    reg = rng.randn(64, 40).astype(np.float32) * 2
    roi = rng.randn(64, 3).astype(np.float32) * 10
    np.testing.assert_allclose(
        n(tcodec.decode_center(t(roi), t(reg), 4.0, 0.8)),
        np.asarray(jcodec.decode_center(jnp.asarray(roi), jnp.asarray(reg),
                                        4.0, 0.8)), atol=1e-5)
    reg2 = rng.randn(64, 52).astype(np.float32)
    anchor = np.array([1.5, 1.6, 3.9], np.float32)
    kw = dict(loc_scope=1.5, loc_bin_size=0.5, num_head_bin=12)
    np.testing.assert_allclose(
        n(tcodec.decode_box_stage2(t(roi), t(reg2), t(anchor), **kw)),
        np.asarray(jcodec.decode_box_stage2(
            jnp.asarray(roi), jnp.asarray(reg2), jnp.asarray(anchor), **kw)),
        atol=1e-5)
    boxes = rng.randn(64, 7).astype(np.float32) * 3
    ref = rng.randn(64, 7).astype(np.float32) * 0.1
    for tf, jf in ((tcodec.center_to_bottom, jcodec.center_to_bottom),
                   (tcodec.bottom_to_center, jcodec.bottom_to_center)):
        np.testing.assert_allclose(n(tf(t(boxes))),
                                   np.asarray(jf(jnp.asarray(boxes))),
                                   atol=1e-5)
    np.testing.assert_allclose(
        n(tcodec.refine_box(t(boxes), t(ref))),
        np.asarray(jcodec.refine_box(jnp.asarray(boxes), jnp.asarray(ref))),
        atol=1e-6)
    pts = rng.randn(3, 20, 5).astype(np.float32)
    ang = rng.randn(3).astype(np.float32)
    np.testing.assert_allclose(
        n(tboxes.rotate_points_along_y(t(pts), t(ang))),
        np.asarray(jboxes.rotate_points_along_y(jnp.asarray(pts),
                                                jnp.asarray(ang))), atol=1e-6)


def _boxes(rng, k):
    b = np.zeros((k, 7), np.float32)
    b[:, 0] = rng.uniform(-4, 4, k)
    b[:, 1] = rng.uniform(0.5, 2.0, k)
    b[:, 2] = rng.uniform(-4, 4, k)
    b[:, 3:6] = rng.uniform(1.0, 4.0, (k, 3))
    b[:, 6] = rng.uniform(-math.pi, math.pi, k)
    return b


def test_iou3d_matches_jax(rng):
    a, b = _boxes(rng, 24), _boxes(rng, 16)
    b[:4] = a[:4]                                   # identical pairs
    ref2, ref3 = jax_iou3d(jnp.asarray(a), jnp.asarray(b))
    got2, got3 = boxes_iou3d(t(a), t(b))
    np.testing.assert_allclose(n(got2), np.asarray(ref2), atol=1e-5)
    np.testing.assert_allclose(n(got3), np.asarray(ref3), atol=1e-5)


def test_greedy_suppress_matches_jax(rng):
    pair = rng.rand(3, 32, 32).astype(np.float32)
    valid = rng.rand(3, 32) < 0.8
    got = n(greedy_suppress(t(pair), 0.7, t(valid)))
    for i in range(3):
        ref = _greedy_suppress(jnp.asarray(pair[i]), 0.7,
                               jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got[i], np.asarray(ref))


def test_top_k_ties_match_lax():
    x = torch.tensor([1.0, 3.0, 3.0, -math.inf, -math.inf, 2.0])
    vals, idx = tinf.top_k(x, 5)
    assert idx.tolist() == [1, 2, 5, 0, 3]
    assert idx.tolist() == np.asarray(
        jax.lax.top_k(jnp.asarray(x.numpy()), 5)[1]).tolist()


def test_rpn_propose_matches_jax(rng):
    B, N = 2, 512
    xyz = rng.uniform(-20, 20, (B, N, 3)).astype(np.float32)
    cls = rng.randn(B, N, 1).astype(np.float32)
    reg = rng.randn(B, N, 40).astype(np.float32) * 3
    got = tinf.rpn_propose(t(cls), t(reg), t(xyz), 4.0, 0.8,
                           pre_nms_top=256, max_proposals=16)
    for i in range(B):
        ref = jinf.rpn_propose(jnp.asarray(cls[i]), jnp.asarray(reg[i]),
                               jnp.asarray(xyz[i]), 4.0, 0.8,
                               pre_nms_top=256, max_proposals=16)
        np.testing.assert_array_equal(n(got[2][i]), np.asarray(ref[2]))
        np.testing.assert_allclose(n(got[0][i]), np.asarray(ref[0]),
                                   atol=1e-5)
        np.testing.assert_allclose(n(got[1][i]), np.asarray(ref[1]),
                                   atol=1e-6)


def test_finalize_matches_jax(rng):
    B, K = 2, 16
    boxes = np.stack([_boxes(rng, K) for _ in range(B)])
    boxes[..., 3:6] = rng.uniform([1.2, 1.3, 2.5], [2.2, 2.0, 5.0],
                                  (B, K, 3)).astype(np.float32)
    boxes[:, 1, :6] = boxes[:, 0, :6] + 0.05        # an overlapping pair
    cls = rng.randn(B, K).astype(np.float32) * 2
    iou = rng.rand(B, K).astype(np.float32)
    centers = rng.randn(B, K, 2).astype(np.float32) * 10
    valid = rng.rand(B, K) < 0.9
    got = tinf.finalize_detections(t(boxes), t(cls), t(iou), t(centers),
                                   t(valid))
    for i in range(B):
        ref = jinf.finalize_detections(*[jnp.asarray(a[i]) for a in (
            boxes, cls, iou, centers, valid)])
        np.testing.assert_array_equal(n(got[2][i]), np.asarray(ref[2]))
        np.testing.assert_allclose(n(got[0][i]), np.asarray(ref[0]),
                                   atol=1e-5)
        np.testing.assert_allclose(n(got[1][i]), np.asarray(ref[1]))
    assert n(got[2]).any()
