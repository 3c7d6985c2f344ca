"""Kernels 3 (full ball query) and 9 (given indices) on the tensor-core
routine of csrc/fused_sa.cu, emulated on the CPU as the kernel computes
them: each query's index row padded from S to Sp = ceil(S / 16) * 16 with
copies of its slot 0, K and N zero-padded to multiples of 8, every product
in three TF32 passes (3xTF32, tests/test_torch_tf32_split.py), max over the
Sp rows. Held within 1e-5 max|ref| against the JAX package's own f32
references on the same numpy-seeded inputs:
ws3d_tpu/ops/fused_sa_bq_pallas.py:_xla_reference (full) and
ws3d_tpu/ops/fused_sa_pallas.py:_xla_reference (given), at the widths these
kernels run: the fitted stage-2 SA2 MLP (131 -> 128 -> 128 -> 256) at S 64
and the backbone SA1 MLPs (99 -> 64 -> 64 -> 128 at S 16, 99 -> 64 -> 96 ->
128 at S 32). The kernel's card gates (1e-3 + 1e-4 max|ref| and 1e-4
max|ref| + 1e-6, tests/torch_card_helpers.py: F32_SA_GATE, GIVEN_GATE)
are far wider."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tf32_split import mlp_padded
from torch_port_helpers import n, sorted_cloud, t
from ws3d_tpu.ops import fused_sa_bq_pallas, fused_sa_pallas
from ws3d_tpu_torch.ops.ball_query import ball_query_multi_plain
from ws3d_tpu_torch.ops.fused_sa_idx import fused_sa_idx_plain

WEIGHTS = "ws3d_tpu/data/bench_weights.npz"
STAGE2_SA2 = "params/rcnn/sa_score_0/sa_2/mlp_0/Dense_{}/{}"

# name: (C, radius, S, widths or None for the fitted stage-2 SA2 MLP,
#        B, P, M, cloud spread)
CASES = {
    "stage2_sa2_s64": (128, 1.0, 64, None, 2, 128, 32, 0.8),
    "backbone_sa1_s16": (96, 0.5, 16, [64, 64, 128], 2, 512, 64, 1.0),
    "backbone_sa1_s32": (96, 1.0, 32, [64, 96, 128], 2, 512, 64, 1.0),
}


def pad_rows(idx: torch.Tensor) -> torch.Tensor:
    """(B, M, S) -> (B, M, Sp): slots S..Sp-1 repeat slot 0, as the kernel
    pads a query's rows to whole m16 tiles."""
    S = idx.shape[-1]
    Sp = -(-S // 16) * 16
    return torch.cat([idx, idx[..., :1].expand(*idx.shape[:-1], Sp - S)],
                     dim=-1)


def _mlp(rng, name):
    C, _, _, widths, *_ = CASES[name]
    if widths is None:
        with np.load(WEIGHTS) as z:
            ks, bs = ([z[STAGE2_SA2.format(i, w)].astype(np.float32)
                       for i in range(3)] for w in ("kernel", "bias"))
        return ks, bs
    ks, bs, ci = [], [], C + 3
    for co in widths:
        ks.append((rng.randn(ci, co) * np.sqrt(2.0 / ci)).astype(np.float32))
        bs.append((rng.randn(co) * 0.1).astype(np.float32))
        ci = co
    return ks, bs


def _inputs(rng, name):
    C, radius, S, _, B, P, M, spread = CASES[name]
    xyz, feat = sorted_cloud(rng, B, P, C, spread=spread)
    new_xyz = xyz[:, np.sort(rng.choice(P, M, replace=False))].copy()
    new_xyz[:, :2, 0] += 50.0               # empty balls: point 0 repeated
    ks, bs = _mlp(rng, name)
    assert ks[0].shape[0] == C + 3
    return xyz, feat, new_xyz, ks, bs


def _check(got, ref, name):
    scale = float(np.abs(ref).max())
    err = float(np.abs(n(got) - ref).max())
    print(f"{name}: max|ref| {scale:.4g}; emulated 3xTF32 max|diff| "
          f"{err:.3g} ({err / scale:.3g} of max)")
    assert scale > 0.1                      # the rows reach the outputs
    assert err <= 1e-5 * scale


@pytest.mark.parametrize("name", sorted(CASES))
def test_full_mode_3xtf32_matches_jax(rng, name):
    """Kernel 3: the ball query (exact, the port's plain version), rows
    padded to Sp, the 3xTF32 MLP; against fused_sa_bq_pallas._xla_reference
    (an XLA ball query over all points, then the f32 MLP)."""
    C, radius, S, *_ = CASES[name]
    xyz, feat, new_xyz, ks, bs = _inputs(rng, name)
    ref = np.asarray(fused_sa_bq_pallas._xla_reference(
        jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(new_xyz), radius, S,
        [jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs]))
    idx = ball_query_multi_plain([radius], [S], t(xyz), t(new_xyz))[0]
    got = mlp_padded(pad_rows(idx), t(xyz), t(feat), t(new_xyz),
                     [t(k) for k in ks], [t(b) for b in bs])
    _check(got, ref, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_given_mode_3xtf32_matches_jax(rng, name):
    """Kernel 9: random given indices, padded to Sp, the 3xTF32 MLP;
    against fused_sa_pallas._xla_reference on the unpadded indices."""
    _, _, S, _, B, P, M, _ = CASES[name]
    xyz, feat, new_xyz, ks, bs = _inputs(rng, name)
    idx = rng.randint(0, P, (B, M, S)).astype(np.int32)
    ref = np.asarray(fused_sa_pallas._xla_reference(
        jnp.asarray(xyz), jnp.asarray(feat), jnp.asarray(new_xyz),
        jnp.asarray(idx), [jnp.asarray(k) for k in ks],
        [jnp.asarray(b) for b in bs]))
    got = mlp_padded(pad_rows(t(idx)), t(xyz), t(feat), t(new_xyz),
                     [t(k) for k in ks], [t(b) for b in bs])
    _check(got, ref, name)


@pytest.mark.parametrize("S", [8, 24, 64])
def test_padding_with_slot_zero_leaves_the_pool(rng, S):
    """The f32 MLP max-pooled over a given index row and over the same row
    padded to Sp with copies of slot 0: bit-equal, since the copies repeat
    slot 0's row exactly."""
    xyz, feat = sorted_cloud(rng, 2, 256, 29)
    new_xyz = xyz[:, np.sort(rng.choice(256, 48, replace=False))]
    ks, bs, ci = [], [], 32
    for co in (64, 64, 128):
        ks.append(t((rng.randn(ci, co) * np.sqrt(2.0 / ci)).astype(
            np.float32)))
        bs.append(t((rng.randn(co) * 0.1).astype(np.float32)))
        ci = co
    idx = t(rng.randint(0, 256, (2, 48, S)).astype(np.int32))
    padded = pad_rows(idx)
    assert padded.shape[-1] == -(-S // 16) * 16
    assert torch.equal(padded[..., :S], idx)
    assert bool((padded[..., S:] == idx[..., :1]).all())
    rows = (t(xyz), t(feat), t(new_xyz), ks, bs)
    assert torch.equal(fused_sa_idx_plain(padded, *rows),
                       fused_sa_idx_plain(idx, *rows))
