"""Kernel 4's bf16 store (interpolate_features(bf16_out=True), kernel 4's
plain version three_interpolate_plain(bf16_out=True)) on the CPU.

- Against the TPU kernel, three_interpolate_pallas(out_dtype=bfloat16,
  interpret=True), within the JAX package's own tolerance for that kernel,
  rtol and atol 2e-2 (three_nn_pallas.py:84-89: it multiplies the weights
  and features in bf16 as well, the port keeps them f32).
- Against the JAX package's XLA path (_interpolate_xla, f32) rounded to bf16
  (round to nearest even): the port computes the same f32 values and rounds
  them once, so the two agree within one bf16 ulp of each value (at most
  2^-7 of it; a last-bit difference in the f32 sum can round the other
  way), and at least 99 % bit for bit.
- The windowed path (kernel 8's plain version on sorted clouds) casts after,
  as the JAX package does: the same bf16 values as the full search.
- The bf16 output's backward is the f32 backward of the cotangent cast to
  f32, as the JAX package's fused path casts it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import n, sorted_cloud, t
from ws3d_tpu.ops.interpolate import _interpolate_fused, _interpolate_xla
from ws3d_tpu.ops.three_nn_pallas import three_interpolate_pallas
from ws3d_tpu_torch.ops.interpolate import (interpolate_features,
                                            three_interpolate_plain)

BF16 = torch.bfloat16


def _cloud(rng, B, n_u, m, C):
    unknown = rng.randn(B, n_u, 3).astype(np.float32) * 2
    known = rng.randn(B, m, 3).astype(np.float32) * 2
    feats = rng.randn(B, m, C).astype(np.float32)
    return unknown, known, feats


@pytest.mark.parametrize("n_u,m,C", [(256, 128, 16), (512, 256, 64),
                                     (1024, 128, 128)])
def test_bf16_store_matches_the_tpu_kernel(rng, n_u, m, C):
    unknown, known, feats = _cloud(rng, 2, n_u, m, C)
    tpu = three_interpolate_pallas(jnp.asarray(unknown), jnp.asarray(known),
                                   jnp.asarray(feats), interpret=True,
                                   out_dtype=jnp.bfloat16)
    got = interpolate_features(t(unknown), t(known), t(feats), bf16_out=True)
    assert got.dtype == BF16 and str(tpu.dtype) == "bfloat16"
    np.testing.assert_allclose(n(got.float()),
                               np.asarray(tpu.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n_u,m,C", [(256, 64, 16), (512, 128, 32),
                                     (96, 2, 8)])
def test_bf16_store_is_the_f32_result_rounded(rng, n_u, m, C):
    unknown, known, feats = _cloud(rng, 2, n_u, m, C)
    ref = np.asarray(_interpolate_xla(
        jnp.asarray(unknown), jnp.asarray(known), jnp.asarray(feats),
        force_xla_nn=True).astype(jnp.bfloat16).astype(jnp.float32))
    got = n(three_interpolate_plain(t(unknown), t(known), t(feats),
                                    bf16_out=True).float())
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -7, atol=0)
    assert (got == ref).mean() >= 0.99
    f32 = n(interpolate_features(t(unknown), t(known), t(feats)))
    assert f32.dtype == np.float32
    assert np.array_equal(got, n(t(f32).to(BF16).float()))


def test_windowed_path_casts_after(rng):
    unknown, _ = sorted_cloud(rng, 2, 512, 1, spread=2.0)
    known, feats = sorted_cloud(rng, 2, 128, 32, spread=2.0)
    win = interpolate_features(t(unknown), t(known), t(feats), sorted_z=True,
                               bf16_out=True)
    full = interpolate_features(t(unknown), t(known), t(feats),
                                bf16_out=True)
    assert win.dtype == BF16
    assert torch.equal(win, full)


@pytest.mark.parametrize("sorted_z", [False, True])
def test_bf16_output_backward_matches_jax(rng, sorted_z):
    """The bf16 output's backward casts the cotangent to f32 and runs the
    f32 backward: bit-equal to the port's f32 backward of the cotangent
    cast to f32, an f32 gradient, and JAX's VJP of the fused path
    (_interpolate_fused(interpret=True, bf16_out=True), whose backward
    casts the same way) within the f32 interpolation's tolerance against
    XLA (atol 1e-4, rtol 1e-5; its 3-NN takes distances through a matmul
    identity)."""
    if sorted_z:
        unknown, _ = sorted_cloud(rng, 2, 256, 1, spread=2.0)
        known, feats = sorted_cloud(rng, 2, 128, 32, spread=2.0)
    else:
        unknown, known, feats = _cloud(rng, 2, 256, 128, 32)
    g = rng.randn(2, 256, 32).astype(np.float32)
    g16 = t(g).to(BF16)
    f = t(feats).requires_grad_(True)
    out = interpolate_features(t(unknown), t(known), f, sorted_z=sorted_z,
                               bf16_out=True)
    assert out.dtype == BF16
    out.backward(g16)
    f32 = t(feats).requires_grad_(True)
    interpolate_features(t(unknown), t(known), f32,
                         sorted_z=sorted_z).backward(g16.float())
    assert f.grad.dtype == torch.float32
    assert torch.equal(f.grad, f32.grad)
    _, vjp = jax.vjp(
        lambda fe: _interpolate_fused(jnp.asarray(unknown), jnp.asarray(known),
                                      fe, True, sorted_z, True),
        jnp.asarray(feats))
    ref = np.asarray(vjp(jnp.asarray(n(g16.float()), jnp.bfloat16))[0])
    np.testing.assert_allclose(n(f.grad), ref, atol=1e-4, rtol=1e-5)
