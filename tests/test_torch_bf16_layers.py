"""The bf16 compute dtype of the port's layers against flax at
dtype=bfloat16 (ws3d_tpu/models/layers.py) on the same numpy inputs and
weights: SharedMLP with and without BatchNorm and with and without
out_f32, HeadMLP with and without BatchNorm.

The rounding model is the same on both sides: a Dense layer rounds its
input and kernel to bf16, sums the products in f32 and returns bf16 with the
bias added in bf16; BatchNorm upcasts to f32; SharedMLP returns f32 unless
out_f32 is False; HeadMLP's last layer is f32. The two sides may sum the
products (and BatchNorm's terms) in other orders, so a bf16 rounding can
fall on the other side: the tolerance is one bf16 ulp of each value (at
most 2^-7 of it) plus 1e-5 of the largest output. Against the same layers
in f32 the bf16 outputs differ by more than 1e-3 of the largest output
(checked, so the comparison sees the rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, t
from ws3d_tpu.models import layers as jlayers
from ws3d_tpu_torch.models.layers import HeadMLP, SharedMLP
from ws3d_tpu_torch.weights import load_flat

BF16 = torch.bfloat16


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


def _tree(flat):
    variables = {"params": {}, "batch_stats": {}}
    for k, v in flat.items():
        coll, *path = k.split("/")
        node = variables[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = jnp.asarray(v)
    return variables


def _check(got: torch.Tensor, ref, f32_ref) -> None:
    ref = np.asarray(ref)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    a = n(got.float()).astype(np.float64)
    b = ref.astype(np.float32).astype(np.float64)
    scale = float(np.abs(b).max())
    assert scale > 0.1
    bad = np.abs(a - b) > 2.0 ** -7 * np.abs(b) + 1e-5 * scale
    assert not bad.any(), (np.abs(a - b).max(), scale)
    # the bf16 rounding is really there: f32 differs by more
    assert np.abs(b - np.asarray(f32_ref, np.float64)).max() > 1e-3 * scale


@pytest.mark.parametrize("use_bn,out_f32", [(True, True), (False, True),
                                            (False, False)])
def test_shared_mlp_bf16_matches_flax(rng, use_bn, out_f32):
    x = rng.randn(2, 16, 8, 35).astype(np.float32)
    jm = jlayers.SharedMLP([64, 48], use_bn=use_bn, dtype=jnp.bfloat16,
                           out_f32=out_f32)
    flat = _randomize(_flat(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))),
                      rng)
    ref = jm.apply(_tree(flat), jnp.asarray(x), train=False)
    f32 = jlayers.SharedMLP([64, 48], use_bn=use_bn).apply(
        _tree(flat), jnp.asarray(x), train=False)
    tm = SharedMLP(35, [64, 48], use_bn=use_bn, dtype=BF16, out_f32=out_f32)
    load_flat(tm, flat)
    with torch.no_grad():
        got = tm(t(x))
    assert got.dtype == (torch.float32 if out_f32 else BF16)
    _check(got, ref, f32)


def test_shared_mlp_bf16_takes_bf16_input(rng):
    """A bf16 chain feeding another (the stage-2 merge_down takes the up
    chains' bf16 output): the same as flax on the same bf16 input."""
    x = rng.randn(4, 32, 256).astype(np.float32)
    jm = jlayers.SharedMLP([128], use_bn=False, dtype=jnp.bfloat16,
                           out_f32=False)
    flat = _randomize(_flat(jm.init(jax.random.PRNGKey(2), jnp.asarray(x))),
                      rng)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jm.apply(_tree(flat), xb)
    f32 = jlayers.SharedMLP([128], use_bn=False).apply(_tree(flat),
                                                       jnp.asarray(x))
    tm = SharedMLP(256, [128], use_bn=False, dtype=BF16, out_f32=False)
    load_flat(tm, flat)
    with torch.no_grad():
        got = tm(t(np.asarray(xb.astype(jnp.float32))).to(BF16))
    _check(got, ref, f32)


@pytest.mark.parametrize("use_bn", [True, False])
def test_head_mlp_bf16_matches_flax(rng, use_bn):
    x = rng.randn(64, 128).astype(np.float32)
    jm = jlayers.HeadMLP([96, 64], out_channels=9, use_bn=use_bn,
                         dp_ratio=0.5, dtype=jnp.bfloat16)
    flat = _randomize(_flat(jm.init(jax.random.PRNGKey(1), jnp.asarray(x))),
                      rng)
    ref = jm.apply(_tree(flat), jnp.asarray(x), train=False)
    f32 = jlayers.HeadMLP([96, 64], out_channels=9, use_bn=use_bn,
                          dp_ratio=0.5).apply(_tree(flat), jnp.asarray(x),
                                              train=False)
    tm = HeadMLP(128, [96, 64], 9, use_bn=use_bn, dp_ratio=0.5, dtype=BF16)
    load_flat(tm, flat)
    with torch.no_grad():
        got = tm(t(x))
    assert got.dtype == torch.float32          # the last layer is f32
    _check(got, ref, f32)
