"""The bf16 mode of the fused SA (kernels 2, 3 and 9: csrc/fused_sa.cu,
fused_sa_tc_kernel<MODE, true>) on the CPU.

1. The plain bf16 versions (ops.fused_sa.fused_sa_plain and
   ops.fused_sa_idx.fused_sa_idx_plain with bf16=True: every product's
   factors rounded to bf16, f32 sums, f32 bias, ReLU and max) against the
   JAX package's Pallas kernels in interpret mode, which are bf16 inside as
   on the TPU (fused_sa_ballquery, fused_sa_window, fused_sa_single_scale),
   and against the f32 references (_xla_reference), on the same numpy
   inputs at the widths kernels 3 and 9 run (tests/test_torch_tf32_split_
   full.py's cases). The TPU kernels round elsewhere (layer 0's
   pre-activations [xyz, feat] @ W0 in bf16, the centre folded into the
   bias in f32), so the two bf16 versions differ by bf16 roundings: the
   tolerance is max|diff| <= 1e-2 max|ref| (the JAX package's own tests
   hold its kernels within 2e-2 of f32 element by element), and bf16 must
   differ from f32 by more than 1e-4 max|ref|.
2. The kernel's fragments emulated: the k8 step packs the f32 fragments of
   the TF32 layout (columns t and t + 4 of rows g and g + 8; rows t and
   t + 4 of B) into bf16 pairs, and mma.sync m16n8k8 bf16 reads a pair as
   columns 2t and 2t + 1. Rebuilt lane by lane as the PTX ISA lays out the
   fragments, the product is bf16(A) @ bf16(B) exactly.
3. The kernel's sums emulated: rows padded to Sp with slot 0, K padded to
   the k step, each step's exact products summed and rounded to f32 once,
   then added in f32 (the accumulators), at the two groupings the kernels
   use (k8: mma.sync m16n8k8; k16: the weight-stationary route's wgmma
   m64n64k16), against the plain bf16 version
   (one f32 matmul): within the card's gate for the bf16 mode
   (tests/torch_card_helpers.py: BF16_GATE, BF16_MEAN_SHARE), max|diff| <=
   1e-3 + 2^-7 max|ref| (other sum orders can move an activation's bf16
   rounding by one ulp) and mean|diff| <= 0.1 mean|bf16 - f32| (such moves
   are rare)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tf32_split_full import CASES, _inputs, pad_rows
from torch_card_helpers import BF16_GATE as CHIP_GATE
from torch_card_helpers import BF16_MEAN_SHARE
from torch_port_helpers import n, t
from ws3d_tpu.ops import (fused_sa_bq_pallas, fused_sa_pallas,
                          fused_sa_window_pallas)
from ws3d_tpu_torch.ops.ball_query import ball_query_multi_plain
from ws3d_tpu_torch.ops.fused_sa import fused_sa_plain
from ws3d_tpu_torch.ops.fused_sa_idx import fused_sa_idx_plain, matmul_bf16
from ws3d_tpu_torch.ops.grouping import group_with_idx

BF16 = torch.bfloat16


def _j(a):
    return jnp.asarray(a)


def _close(got, ref, what, rel=1e-2):
    scale = float(np.abs(ref).max())
    err = float(np.abs(np.asarray(got, np.float64) - ref).max())
    print(f"{what}: max|ref| {scale:.4g}, max|diff| {err:.3g} "
          f"({err / scale:.3g} of max)")
    assert scale > 0.1
    assert err <= rel * scale
    return err / scale


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mode", ["full", "window"])
def test_plain_bf16_matches_the_jax_kernels(rng, name, mode):
    """Kernels 3 (full) and 2 (window; the cases' clouds and queries are
    sorted by z)."""
    C, radius, S, *_ = CASES[name]
    xyz, feat, new_xyz, ks, bs = _inputs(rng, name)
    jargs = (_j(xyz), _j(feat), _j(new_xyz), radius, S,
             [_j(k) for k in ks], [_j(b) for b in bs])
    kernel = (fused_sa_bq_pallas.fused_sa_ballquery if mode == "full"
              else fused_sa_window_pallas.fused_sa_window)
    tpu = np.asarray(kernel(*jargs, interpret=True))
    f32 = np.asarray(fused_sa_bq_pallas._xla_reference(*jargs))
    got = n(fused_sa_plain(t(xyz), t(feat), t(new_xyz), radius, S,
                           [t(k) for k in ks], [t(b) for b in bs], bf16=True))
    _close(got, tpu, f"{name} {mode}: plain bf16 vs the TPU kernel")
    rel = _close(got, f32, f"{name} {mode}: plain bf16 vs f32")
    assert rel > 1e-4                       # the bf16 rounding is there
    same = n(fused_sa_plain(t(xyz), t(feat), t(new_xyz), radius, S,
                            [t(k) for k in ks], [t(b) for b in bs]))
    np.testing.assert_allclose(same, f32, rtol=1e-5, atol=1e-5 * float(
        np.abs(f32).max()))                 # f32 stays f32


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_bf16_given_indices_matches_the_jax_kernel(rng, name):
    """Kernel 9 on random given indices."""
    _, _, S, _, B, P, M, _ = CASES[name]
    xyz, feat, new_xyz, ks, bs = _inputs(rng, name)
    idx = rng.randint(0, P, (B, M, S)).astype(np.int32)
    jargs = (_j(xyz), _j(feat), _j(new_xyz), _j(idx), [_j(k) for k in ks],
             [_j(b) for b in bs])
    tpu = np.asarray(fused_sa_pallas.fused_sa_single_scale(*jargs,
                                                           interpret=True))
    f32 = np.asarray(fused_sa_pallas._xla_reference(*jargs))
    got = n(fused_sa_idx_plain(t(idx), t(xyz), t(feat), t(new_xyz),
                               [t(k) for k in ks], [t(b) for b in bs],
                               bf16=True))
    _close(got, tpu, f"{name} given: plain bf16 vs the TPU kernel")
    assert _close(got, f32, f"{name} given: plain bf16 vs f32") > 1e-4


def test_bf16_features_are_cast_exactly(rng):
    """Features that arrive in bf16 (the stage-2 up/merge chains) give the
    result of the same values in f32."""
    C, radius, S, *_ = CASES["stage2_sa2_s64"]
    xyz, feat, new_xyz, ks, bs = _inputs(rng, "stage2_sa2_s64")
    fb = t(feat).to(BF16)
    args = ([t(k) for k in ks], [t(b) for b in bs])
    from ws3d_tpu_torch.ops.fused_sa import fused_sa
    a = fused_sa(t(xyz), fb, t(new_xyz), radius, S, *args, window=True,
                 bf16=True)
    b = fused_sa(t(xyz), fb.float(), t(new_xyz), radius, S, *args,
                 window=True, bf16=True)
    assert a.dtype == torch.float32 and torch.equal(a, b)


def test_fragment_pairing_is_a_k_permutation(rng):
    """The bf16 k8 step's fragments rebuilt lane by lane: A's registers
    (lo, hi) = (X[g][t], X[g][t + 4]) and (X[g + 8][t], X[g + 8][t + 4]),
    B's (W[t][g], W[t + 4][g]), read by mma.sync m16n8k8 bf16 as A[g][2t],
    A[g][2t + 1], A[g + 8][2t], A[g + 8][2t + 1] and B[2t][g],
    B[2t + 1][g]: the hardware's A and B are X and W with k renumbered the
    same way, so A @ B = bf16(X) @ bf16(W) exactly."""
    X = t(rng.randn(16, 8).astype(np.float32)).to(BF16).double()
    W = t(rng.randn(8, 8).astype(np.float32)).to(BF16).double()
    A = torch.full((16, 8), float("nan"), dtype=torch.float64)
    Bm = torch.full((8, 8), float("nan"), dtype=torch.float64)
    for lane in range(32):
        g, tg = lane >> 2, lane & 3
        ra = [X[g, tg], X[g + 8, tg], X[g, tg + 4], X[g + 8, tg + 4]]
        rb = [W[tg, g], W[tg + 4, g]]
        regs_a = [(ra[0], ra[2]), (ra[1], ra[3])]      # pack_bf16x2(lo, hi)
        reg_b = (rb[0], rb[1])
        for row, reg in ((g, regs_a[0]), (g + 8, regs_a[1])):
            A[row, 2 * tg], A[row, 2 * tg + 1] = reg
        Bm[2 * tg, g], Bm[2 * tg + 1, g] = reg_b
    assert not (torch.isnan(A).any() or torch.isnan(Bm).any())
    assert torch.equal(A @ Bm, X @ W)


def _mm_k(a: torch.Tensor, b: torch.Tensor, step: int) -> torch.Tensor:
    """bf16 factors, K padded to `step`; each step's exact products summed
    and rounded to f32 once, the steps added in f32."""
    pad = (-a.shape[-1]) % step
    a = torch.nn.functional.pad(a, (0, pad)).to(BF16).double()
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).to(BF16).double()
    acc = torch.zeros(a.shape[:-1] + (b.shape[1],))
    for k0 in range(0, a.shape[-1], step):
        acc = acc + (a[..., k0:k0 + step] @ b[k0:k0 + step]).float()
    return acc


@pytest.mark.parametrize("name,step", [
    pytest.param(n, k, id=n if k == 8 else f"{n}-k{k}")
    for k in (8, 16) for n in sorted(CASES)])
def test_emulated_sums_hold_the_chip_gate(rng, name, step):
    C, radius, S, *_ = CASES[name]
    xyz, feat, new_xyz, ks, bs = _inputs(rng, name)
    ks, bs = [t(k) for k in ks], [t(b) for b in bs]
    idx = ball_query_multi_plain([radius], [S], t(xyz), t(new_xyz))[0]
    h = group_with_idx(pad_rows(idx).long(), t(xyz), t(new_xyz), t(feat))
    for k, b in zip(ks, bs):
        h = torch.relu(_mm_k(h, k, step) + b)
    got = torch.amax(h, dim=2)
    ref = fused_sa_idx_plain(idx, t(xyz), t(feat), t(new_xyz), ks, bs,
                             bf16=True)
    f32 = fused_sa_idx_plain(idx, t(xyz), t(feat), t(new_xyz), ks, bs)
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    mean, rounding = (float((got - ref).abs().mean()),
                      float((ref - f32).abs().mean()))
    print(f"{name}: emulated k{step} sums vs the plain bf16 version: max|diff| "
          f"{err:.3g} of max|ref| {scale:.4g}, mean {mean:.3g} against "
          f"bf16's {rounding:.3g} from f32")
    assert err <= CHIP_GATE[0] + CHIP_GATE[1] * scale
    assert mean <= BF16_MEAN_SHARE * rounding
    # the plain version's product is the f32 sum of exact bf16 products
    a, w = h[..., :8], ks[-1][:8]
    exact = (a.to(BF16).double() @ w.to(BF16).double()).float()
    assert float((matmul_bf16(a, w) - exact).abs().max()) <= 1e-5 * float(
        exact.abs().max())


def test_fused_sa_resident_reader():
    """benchmark/metrics/fused_sa.resident.py: the program's
    `fused_sa.resident` counter a traced batch or scene, None without it."""
    from benchmark import harness
    from ws3d_tpu_torch.utils.profiling import count
    rec = {"iters": 2}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        pass                                 # no counter
    assert harness.read_metric("infer.fused_sa.resident", rec) is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        for _ in range(20):
            count("fused_sa.resident")
    assert harness.read_metric("infer.fused_sa.resident", rec) == 10.0
    assert harness.read_metric("scene.fused_sa.resident", rec) == 10.0
