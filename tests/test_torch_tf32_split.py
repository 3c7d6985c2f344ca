"""The numerics of kernel 2's tensor-core MLP (csrc/fused_sa.cu, windowed
mode), emulated on the CPU: 3-pass split TF32 ("3xTF32"). Each f32 operand
x splits into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (cvt.rna: round to
nearest, ties away from zero, 10 stored mantissa bits); each product is
lo_a*hi_b + hi_a*lo_b + hi_a*hi_b in f32 (TF32 products are exact in f32),
small terms first, lo*lo dropped. Held against the f32 plain MLP
(fused_sa_idx_plain) within the card's gate of kernel 2, 1e-3 + 1e-4
max|ref| (tests/torch_card_helpers.py: F32_SA_GATE), at the fitted stage-2
SA MLP (131 -> 128 -> 128 -> 128) and at the backbone's 259 -> 128 -> 196
-> 256, with K and N padded to multiples of 8 as the kernel pads them."""
import numpy as np
import pytest
import torch

from torch_card_helpers import F32_SA_GATE, within
from torch_port_helpers import t
from ws3d_tpu_torch.ops.fused_sa_idx import fused_sa_idx_plain
from ws3d_tpu_torch.ops.grouping import group_with_idx

WEIGHTS = "ws3d_tpu/data/bench_weights.npz"
STAGE2_SA = "params/rcnn/sa_score_0/sa_{}/mlp_0/Dense_{}/{}"


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 by bit arithmetic: add half of the 13 dropped bits'
    weight to the magnitude (the sign bit is apart, so ties go away from
    zero), then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(rna_tf32(a), rna_tf32(b))


def pad8(c: int) -> int:
    return -(-c // 8) * 8


def mlp_emulated(idx, xyz, feat, new_xyz, kernels, biases, mm):
    """The kernel's arithmetic: group, per layer mm + bias + ReLU, then max
    over the S samples."""
    h = group_with_idx(idx.long(), xyz, new_xyz, feat)
    for k, b in zip(kernels, biases):
        h = torch.relu(mm(h, k) + b)
    return torch.amax(h, dim=2)


def mlp_padded(idx, xyz, feat, new_xyz, kernels, biases):
    """mlp_emulated in 3xTF32 with K and N zero-padded to multiples of 8,
    as the kernel pads them, and the padding cut off at the end."""
    h = group_with_idx(idx.long(), xyz, new_xyz, feat)
    h = torch.nn.functional.pad(h, (0, pad8(h.shape[-1]) - h.shape[-1]))
    for k, b in zip(kernels, biases):
        ci, co = k.shape
        k = torch.nn.functional.pad(k, (0, pad8(co) - co, 0, h.shape[-1] - ci))
        b = torch.nn.functional.pad(b, (0, pad8(co) - co))
        h = torch.relu(mm_3xtf32(h, k) + b)
        assert bool((h[..., co:] == 0).all())   # padded columns stay 0
    return torch.amax(h[..., :kernels[-1].shape[1]], dim=2)


def _stage2_mlp():
    with np.load(WEIGHTS) as z:
        ks, bs = ([t(z[STAGE2_SA.format(0, i, w)].astype(np.float32))
                   for i in range(3)] for w in ("kernel", "bias"))
    return ks, bs


def _backbone_mlp(rng):
    ks, bs, ci = [], [], 259
    for co in (128, 196, 256):
        ks.append(t((rng.randn(ci, co) * np.sqrt(2.0 / ci)).astype(np.float32)))
        bs.append(t((rng.randn(co) * 0.1).astype(np.float32)))
        ci = co
    return ks, bs


def _rows(rng, B, P, M, S, C, radius, feat_scale):
    """Gathered rows scaled like the real ones: centre offsets within the
    radius, ReLU-like features."""
    xyz = (rng.randn(B, P, 3) * radius).astype(np.float32)
    new_xyz = xyz[:, :M] + (rng.randn(B, M, 3) * 0.1 * radius).astype(
        np.float32)
    feat = (rng.exponential(feat_scale, (B, P, C))
            * (rng.rand(B, P, C) < 0.6)).astype(np.float32)
    idx = rng.randint(0, P, (B, M, S)).astype(np.int32)
    return t(idx), t(xyz), t(feat), t(new_xyz)


CASES = {"stage2_sa": (128, 0.3, 16, 1.0), "backbone_259": (256, 1.5, 32, 2.0)}


def _case(name, rng):
    C, radius, S, feat_scale = CASES[name]
    ks, bs = _stage2_mlp() if name == "stage2_sa" else _backbone_mlp(rng)
    assert ks[0].shape[0] == C + 3
    return _rows(rng, 2, 256, 64, S, C, radius, feat_scale), ks, bs


@pytest.mark.parametrize("name", sorted(CASES))
def test_3xtf32_mlp_holds_the_f32_gate(rng, name):
    (idx, xyz, feat, new_xyz), ks, bs = _case(name, rng)
    ref = fused_sa_idx_plain(idx, xyz, feat, new_xyz, ks, bs)
    got = mlp_emulated(idx, xyz, feat, new_xyz, ks, bs, mm_3xtf32)
    one = mlp_emulated(idx, xyz, feat, new_xyz, ks, bs, mm_tf32)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    err1 = float((one - ref).abs().max())
    print(f"{name}: max|ref| {scale:.4g}; 3xTF32 max|diff| {err:.3g} "
          f"({err / scale:.3g} of max), single-pass TF32 {err1:.3g} "
          f"({err1 / scale:.3g} of max)")
    assert scale > 0.1                       # the rows reach the outputs
    assert within(err, scale, F32_SA_GATE)
    # the split keeps ~22 bits: far inside the gate
    assert err <= 1e-5 * scale


@pytest.mark.parametrize("name", sorted(CASES))
def test_padding_to_eight_leaves_the_output(rng, name):
    """K and N zero-padded to multiples of 8 (131 -> 136, 196 -> 200,
    259 -> 264): the zero rows and columns add exact zeros."""
    (idx, xyz, feat, new_xyz), ks, bs = _case(name, rng)
    base = mlp_emulated(idx, xyz, feat, new_xyz, ks, bs, mm_3xtf32)
    padded = mlp_padded(idx, xyz, feat, new_xyz, ks, bs)
    assert padded.shape == base.shape
    assert float((padded - base).abs().max()) <= 1e-6 * float(
        base.abs().max())


def test_split_bits(rng):
    x = t(np.concatenate([rng.randn(4096) * 10.0 ** rng.randint(-6, 6, 4096),
                          [1.0, -1.0, 1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                           3.0 * 2.0 ** -12]]).astype(np.float32))
    hi, lo = split_tf32(x)
    assert bool(((hi.view(torch.int32) & 0x1fff) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1fff) == 0).all())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    # ties go away from zero: 1 + 2^-11 lies halfway between TF32 1 and
    # 1 + 2^-10
    assert hi[-3].item() == 1 + 2.0 ** -10
    assert hi[-2].item() == -(1 + 2.0 ** -10)
