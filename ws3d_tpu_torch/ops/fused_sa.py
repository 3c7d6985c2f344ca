"""Fused set abstraction (kernels 2 and 3: csrc/fused_sa.cu) and its
backward.

One function: ball query, gather of [xyz - q, feat] rows, the BN-folded
ReLU MLP and a max over the S samples. The CUDA source has two entry points
for it: the windowed one (ws3d_tpu/ops/fused_sa_window_pallas.py, which
scans only the z-window of each query) is for points and queries sorted
ascending by z; the full one (ws3d_tpu/ops/fused_sa_bq_pallas.py) takes any
order. Both search with kernel 6's staged search, which skips the chunks
outside a query's z slab after a pre-pass (so on sorted clouds it keeps
the window's points and gives the window's indices), and both, with kernel
9's given indices (ops/fused_sa_idx.py), run one routine: the search and
the gather in exact f32 on the SIMT cores, the MLP on the tensor cores in
three TF32 passes (3xTF32, about 22 mantissa bits). The plain version is
the f32 composition of fused_sa_bq_pallas._xla_reference. With bf16=True
(cfg.TPU.COMPUTE_DTYPE=bfloat16) the MLP's products take bf16 factors and
f32 sums (fused_sa_idx.matmul_bf16), on CUDA the kernels' bf16 mode; the
search stays exact f32. That is the rounding of the JAX package's XLA bf16
path; the TPU kernels round layer 0 otherwise (fused_sa_bq_pallas.
layer0_preact: [xyz, feat] @ W0 with absolute coordinates, stored in bf16),
which the port does not reproduce (ROADMAP.md queue 3). Where the stack's
bf16 weights fit in shared memory (`resident`: stage 1's SA0 and SA1, the
stage-2 stacks) the bf16 modes run on the kernels' weight-stationary route
(persistent blocks, the MLP on wgmma, the next tiles' searches and gathers
under it): the same factors, their f32 sums grouped by k16 instead of k8.
Features that arrive in bf16 (the stage-2 up/merge chains) are cast to f32
first, which is exact.

FusedSA gives both a backward, for the BN-free stage-2 SA stacks in train
mode. In bf16 its forward is the kernels' rounded-layer mode (the
round_layers argument: each layer's output rounded as flax's
Dense(dtype=bfloat16) rounds it, the bias added in bf16), which is the JAX
package's bf16 XLA composition, and its backward the VJP of that composition
(sa_from_idx_backward's bf16 mode; fused_sa_idx's docstring). The
BN-free stacks' eval takes the rounded-layer mode too; the BN stacks' eval
keeps the bf16 mode with f32 bias and last layer. Like the JAX custom VJPs
(fused_sa_bq_pallas.py:213-239, fused_sa_window_pallas.py:326-351) it saves
only xyz, features, new_xyz and the weights, never the grouped tensor. Its
backward takes the ball-query indices from kernel 6 (grouping.ball_query)
and differentiates the MLP with them held constant
(fused_sa_idx.sa_from_idx_backward). For the windowed entry the JAX backward
re-runs an XLA ball query over all points instead; the indices are the same,
because the window drops no in-ball point, so kernel 6 serves both entries
here.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.ball_query import ball_query_multi_plain
from ws3d_tpu_torch.ops.fused_sa_idx import (  # noqa: F401 (re-exported)
    check_mlp, fused_sa_idx_plain, matmul_bf16, pack_params,
    sa_from_idx_backward)
from ws3d_tpu_torch.ops.grouping import ball_query
from ws3d_tpu_torch.utils.profiling import count


def fused_sa_plain(xyz, features, new_xyz, radius: float, nsample: int,
                   kernels: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor],
                   bf16: bool = False,
                   round_layers: bool = False) -> torch.Tensor:
    """Plain version: ball query + group + dense stack + max over S (bf16:
    bf16 factors, f32 sums; round_layers: each layer rounded as flax's bf16
    Dense rounds it)."""
    idx = ball_query_multi_plain([radius], [nsample], xyz, new_xyz)[0]
    return fused_sa_idx_plain(idx, xyz, features, new_xyz, kernels, biases,
                              bf16, round_layers)


@functools.lru_cache(maxsize=None)
def resident(C: int, nsample: int, prec: int, widths: tuple) -> bool:
    """Whether ws3d_fused_sa runs a call of these shapes in precision
    `prec` (0 3xTF32, 1 bf16, 2 rounded-layer bf16) on its weight-stationary
    route: the kernel library's own rule (csrc/fused_sa.cu:
    plan_resident), asked through ws3d_fused_sa_resident."""
    w = (_kernels.ctypes.c_int * len(widths))(*widths)
    return bool(_kernels.library().ws3d_fused_sa_resident(
        int(C), int(nsample), int(prec), len(widths) - 1, w))


def fused_sa_cuda(xyz, features, new_xyz, radius: float, nsample: int,
                  kernels, biases, window: bool,
                  params: torch.Tensor | None = None,
                  bf16: bool = False,
                  round_layers: bool = False) -> torch.Tensor:
    """Kernels 2 (window=True) and 3: (B, P, 3), (B, P, C), (B, M, 3) f32
    CUDA -> (B, M, C_last), in the bf16 mode with `bf16`, its rounded-layer
    mode with `round_layers` too. `params` is pack_params(kernels, biases)
    made ahead by the caller, or None to pack here. Counts
    `fused_sa.resident` once a call that takes the weight-stationary
    route (`resident`)."""
    B, P, _ = xyz.shape
    M = new_xyz.shape[1]
    C = features.shape[-1]
    _kernels.check_cuda(xyz, "fused_sa xyz", torch.float32, (None, None, 3))
    _kernels.check_cuda(features, "fused_sa features", torch.float32,
                        (B, P, None))
    _kernels.check_cuda(new_xyz, "fused_sa new_xyz", torch.float32,
                        (B, None, 3))
    widths, params = check_mlp("fused_sa", C, kernels, biases, params)
    out = torch.empty((B, M, widths[len(kernels)]), dtype=torch.float32,
                      device=xyz.device)
    r = float(radius)
    prec = (2 if round_layers else 1) if bf16 else 0
    # the search skips chunks by their z range (a pre-pass writes them)
    bounds = _kernels.chunk_bounds_workspace(xyz)
    name = ("fused_sa_window" if window else "fused_sa_full") + (
        "", "_bf16", "_bf16r")[prec]
    _kernels.launch(
        name, "ws3d_fused_sa",
        xyz.data_ptr(), features.data_ptr(), new_xyz.data_ptr(), B, P, C, M,
        r * r, int(nsample), int(bool(window)), prec, len(kernels),
        widths, params.data_ptr(), out.data_ptr(), bounds.data_ptr(),
        _kernels.stream_ptr(xyz))
    if prec and resident(C, int(nsample), prec, tuple(widths)):
        count("fused_sa.resident")
    return out


def fused_sa(xyz, features, new_xyz, radius: float, nsample: int, kernels,
             biases, window: bool, params: torch.Tensor | None = None,
             bf16: bool = False, round_layers: bool = False) -> torch.Tensor:
    """Set abstraction for one scale: the kernel on CUDA tensors, the plain
    version on CPU tensors. `window` requires z-sorted points and queries;
    `params` (the kernel's packed weights) is used only on CUDA; `bf16`
    selects the bf16 mode and `round_layers` with it the rounded-layer mode
    (features in bf16 are cast to f32 first)."""
    features = features.float()
    if xyz.is_cuda:
        return fused_sa_cuda(xyz, features, new_xyz, radius, nsample,
                             kernels, biases, window, params=params,
                             bf16=bf16, round_layers=round_layers)
    return fused_sa_plain(xyz, features, new_xyz, radius, nsample, kernels,
                          biases, bf16, round_layers)


class FusedSA(torch.autograd.Function):
    """fused_sa with a backward (see the module docstring). apply(xyz,
    features, new_xyz, radius, nsample, window, bf16, n_layers, *kernels,
    *biases); gradients reach every tensor input that requires one, xyz and
    new_xyz through the centre subtraction. With `bf16` the forward is the
    rounded-layer bf16 mode (each layer rounded as flax's bf16 Dense rounds
    it) and the backward sa_from_idx_backward's bf16 mode, its VJP."""

    @staticmethod
    def forward(ctx, xyz, features, new_xyz, radius, nsample, window, bf16,
                n_layers, *weights):
        ctx.radius, ctx.nsample, ctx.n_layers = radius, nsample, n_layers
        ctx.bf16 = bf16
        ctx.save_for_backward(xyz, features, new_xyz, *weights)
        return fused_sa(xyz, features, new_xyz, radius, nsample,
                        weights[:n_layers], weights[n_layers:], window,
                        bf16=bf16, round_layers=bf16)

    @staticmethod
    def backward(ctx, grad_out):
        xyz, features, new_xyz, *weights = ctx.saved_tensors
        L = ctx.n_layers
        idx = ball_query(ctx.radius, ctx.nsample, xyz, new_xyz)
        needs = ctx.needs_input_grad[:3] + ctx.needs_input_grad[8:]
        g = sa_from_idx_backward(idx, xyz, features, new_xyz, weights[:L],
                                 weights[L:], grad_out.contiguous(), needs,
                                 bf16=ctx.bf16)
        return (*g[:3], None, None, None, None, None, *g[3:])


def fused_sa_train(xyz, features, new_xyz, radius: float, nsample: int,
                   kernels: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor],
                   window: bool, bf16: bool = False) -> torch.Tensor:
    """Differentiable fused SA on the live (unfolded, BN-free) weights;
    `bf16` as FusedSA's."""
    return FusedSA.apply(xyz, features, new_xyz, float(radius), int(nsample),
                         bool(window), bool(bf16), len(kernels), *kernels,
                         *biases)
