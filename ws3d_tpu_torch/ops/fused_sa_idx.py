"""Set abstraction with given indices (kernel 9: the given mode of
csrc/fused_sa.cu), and the given-index backward every fused SA shares.

Port of ws3d_tpu/ops/fused_sa_pallas.py: for each query its S given point
indices, rows [xyz - q, feat], the ReLU MLP and a max over S. The TPU kernel
gathers with a one-hot bf16 matmul and folds the centre into the first
layer's bias; the CUDA kernel gathers the f32 rows and subtracts the centre,
which is the same function, and runs the routine of kernels 2 and 3 with the
caller's indices in place of the ball query: the MLP on the tensor cores in
three TF32 passes (3xTF32), each row padded from S to a multiple of 16 with
copies of its slot 0, which leave the max unchanged. No model path of the
JAX package launches kernel 9 (only its tests call fused_sa_single_scale),
and none of the port does: it runs from its own entry point,
fused_sa_single_scale.

With bf16=True each product's two factors are rounded to bf16 (round to
nearest even) and the products summed in f32, with f32 bias, ReLU and max:
the rounding of the JAX package's XLA bf16 path, and of the TPU kernel's
layers after the first (bf16 multiplicands, f32 accumulation). Its layer 0
rounds the gathered [xyz, feat] rows, absolute coordinates included, to
bf16 and folds the centre into the bias; the port rounds the
centre-relative rows (ROADMAP.md queue 3). On CUDA that is the kernel's
bf16 mode (one bf16 mma.sync a product in place of three TF32 ones).

Its backward, sa_from_idx_backward, is the JAX VJP of _xla_reference with
the indices held constant: recompute group -> MLP -> amax under autograd and
differentiate. It is also the backward of kernels 2 and 3
(ops/fused_sa.FusedSA), as fused_sa_bq_pallas._mlp_from_idx is in the JAX
package. torch.amax splits the gradient evenly among tied samples (the
padded duplicates), as JAX's max does.

Its bf16 mode is the VJP of the JAX package's bf16 XLA composition, the
path its CPU takes (pointnet2.py:_use_fused is false there): flax's
Dense(dtype=bfloat16) on the grouped rows, whose output is the f32 sum of
bf16 products rounded to bf16 with the bias added in bf16, ReLU in bf16,
and the stack's output cast to f32 before the max (mlp_flax_bf16).
Autodiff of that rounds every layer's output cotangent and each weight
gradient to bf16 (the weight gradients return in f32), and pools over the
bf16-valued last layer, so equal maxima are tied as JAX ties them: the
kernels' f32 output has fewer ties, and their gradient would go to other
samples. The TPU's custom VJP (_mlp_from_idx) differentiates an f32
composition instead; the port does not copy it (ROADMAP.md queue 3).
"""
from __future__ import annotations

from typing import Sequence

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.grouping import group_with_idx


def matmul_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both factors rounded to bf16 (round to nearest even) and
    the products summed in f32, as jax.lax.dot_general(a.astype(bf16),
    b.astype(bf16), preferred_element_type=f32): an f32 result. The rounded
    factors are exact in f32 (and in TF32), so each product is exact."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        b.to(torch.bfloat16).float())


def pack_params(kernels, biases) -> torch.Tensor:
    """[W0, b0, W1, b1, ...] as one f32 buffer; each W (ci, co) row-major
    with zero rows appended up to a multiple of 4 (the kernel's row pad)."""
    parts = []
    for k, b in zip(kernels, biases):
        k = torch.nn.functional.pad(k, (0, 0, 0, (-k.shape[0]) % 4))
        parts += [k.reshape(-1), b.reshape(-1)]
    return torch.cat(parts).float().contiguous()


def check_mlp(name: str, C: int, kernels, biases, params):
    """Raise unless the layers chain from 3 + C with widths that are
    multiples of 4; returns (ctypes widths array, the packed params)."""
    widths = [C + 3] + [int(k.shape[1]) for k in kernels]
    if any(w % 4 for w in widths[1:]):
        raise ValueError(f"{name}: layer widths {widths[1:]} must be "
                         f"multiples of 4")
    for i, (k, b) in enumerate(zip(kernels, biases)):
        if tuple(k.shape) != (widths[i], widths[i + 1]) or \
                tuple(b.shape) != (widths[i + 1],):
            raise ValueError(f"{name} layer {i}: kernel {tuple(k.shape)} "
                             f"bias {tuple(b.shape)} do not chain from "
                             f"{widths[i]}")
    if params is None:
        params = pack_params(kernels, biases)
    n_params = sum(-(-w // 4) * 4 * wo + wo
                   for w, wo in zip(widths[:-1], widths[1:]))
    _kernels.check_cuda(params, f"{name} params", torch.float32, (n_params,))
    return (_kernels.ctypes.c_int * len(widths))(*widths), params


def dense_bf16(x: torch.Tensor, kernel: torch.Tensor,
               bias: torch.Tensor | None) -> torch.Tensor:
    """flax's Dense(dtype=bfloat16): the f32 sum of bf16 products rounded
    to bf16, plus the bias rounded to bf16, the sum rounded again (bf16)."""
    y = matmul_bf16(x, kernel).to(torch.bfloat16)
    return y if bias is None else y + bias.to(torch.bfloat16)


def mlp_flax_bf16(h: torch.Tensor, kernels, biases) -> torch.Tensor:
    """The ReLU stack of dense_bf16 layers, all in bf16; the output cast to
    f32 (bf16-valued)."""
    for k, b in zip(kernels, biases):
        h = torch.relu(dense_bf16(h, k, b))
    return h.float()


def fused_sa_idx_plain(idx, xyz, features, new_xyz,
                       kernels: Sequence[torch.Tensor],
                       biases: Sequence[torch.Tensor],
                       bf16: bool = False,
                       round_layers: bool = False) -> torch.Tensor:
    """Plain version, the f32 composition of
    fused_sa_pallas._xla_reference: idx (B, M, S) -> group -> dense stack
    with ReLU -> max over S -> (B, M, C_last); with `bf16` every layer's
    product is matmul_bf16, and with `round_layers` too the stack is
    mlp_flax_bf16 (the kernels' rounded-layer mode)."""
    h = group_with_idx(idx.long(), xyz, new_xyz, features)
    if bf16 and round_layers:
        return torch.amax(mlp_flax_bf16(h, kernels, biases), dim=2)
    mm = matmul_bf16 if bf16 else torch.matmul
    for k, b in zip(kernels, biases):
        h = torch.relu(mm(h, k) + b)
    return torch.amax(h, dim=2)


def fused_sa_idx_cuda(xyz, features, new_xyz, idx, kernels, biases,
                      bf16: bool = False) -> torch.Tensor:
    """Kernel 9: (B, P, 3), (B, P, C), (B, M, 3) f32 and idx (B, M, S)
    int32 in [0, P), all CUDA -> (B, M, C_last); `bf16` launches the bf16
    mode."""
    _kernels.check_cuda(xyz, "fused_sa_idx xyz", torch.float32,
                        (None, None, 3))
    B, P, _ = xyz.shape
    _kernels.check_cuda(features, "fused_sa_idx features", torch.float32,
                        (B, P, None))
    _kernels.check_cuda(new_xyz, "fused_sa_idx new_xyz", torch.float32,
                        (B, None, 3))
    M = new_xyz.shape[1]
    _kernels.check_cuda(idx, "fused_sa_idx idx", torch.int32, (B, M, None))
    C, S = features.shape[-1], idx.shape[-1]
    widths, params = check_mlp("fused_sa_idx", C, kernels, biases, None)
    out = torch.empty((B, M, widths[len(kernels)]), dtype=torch.float32,
                      device=xyz.device)
    name = "fused_sa_idx_bf16" if bf16 else "fused_sa_idx"
    _kernels.launch(
        name, "ws3d_fused_sa_idx",
        xyz.data_ptr(), features.data_ptr(), new_xyz.data_ptr(),
        idx.data_ptr(), B, P, C, M, S, len(kernels), widths,
        params.data_ptr(), out.data_ptr(), int(bool(bf16)),
        _kernels.stream_ptr(xyz))
    return out


def sa_from_idx_backward(idx, xyz, features, new_xyz, kernels, biases,
                         grad_out, needs, bf16: bool = False):
    """The given-index VJP: gradients of fused_sa_idx_plain at these inputs
    with idx held constant, for the inputs (xyz, features, new_xyz,
    *kernels, *biases) whose entry of `needs` is true (None for the rest);
    with `bf16`, of its rounded-layer mode, group -> mlp_flax_bf16 -> max
    (see the module docstring). Each gradient has its input's dtype. The
    grouped rows are recomputed here and freed on return."""
    inputs = [xyz, features, new_xyz, *kernels, *biases]
    L = len(kernels)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(bool(w))
                  for x, w in zip(inputs, needs)]
        # bf16 features join the f32 rows exactly before the gather, as
        # JAX's concat promotes them: the scatter-add sums in f32
        out = fused_sa_idx_plain(idx, leaves[0], leaves[1].float(),
                                 leaves[2], leaves[3:3 + L], leaves[3 + L:],
                                 bf16=bf16, round_layers=bf16)
        wanted = [x for x, w in zip(leaves, needs) if w]
        grads = iter(torch.autograd.grad(out, wanted, grad_out)
                     if wanted else ())
    return [next(grads) if w else None for w in needs]


def fused_sa_idx(xyz, features, new_xyz, idx, kernels, biases,
                 bf16: bool = False) -> torch.Tensor:
    """SA with given indices, forward only: kernel 9 on CUDA tensors (idx
    int32), the plain version on CPU tensors; `bf16` selects the bf16
    mode."""
    if xyz.is_cuda:
        return fused_sa_idx_cuda(xyz, features, new_xyz, idx, kernels,
                                 biases, bf16=bf16)
    return fused_sa_idx_plain(idx, xyz, features, new_xyz, kernels, biases,
                              bf16)


class _FusedSAIdx(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, features, new_xyz, idx, n_layers, *weights):
        kernels, biases = weights[:n_layers], weights[n_layers:]
        ctx.n_layers = n_layers
        ctx.save_for_backward(xyz, features, new_xyz, idx, *weights)
        return fused_sa_idx(xyz, features, new_xyz, idx, kernels, biases)

    @staticmethod
    def backward(ctx, grad_out):
        xyz, features, new_xyz, idx, *weights = ctx.saved_tensors
        L = ctx.n_layers
        needs = ctx.needs_input_grad[:3] + ctx.needs_input_grad[5:]
        g = sa_from_idx_backward(idx, xyz, features, new_xyz, weights[:L],
                                 weights[L:], grad_out.contiguous(), needs)
        return (*g[:3], None, None, *g[3:])


def fused_sa_single_scale(xyz, features, new_xyz, idx, kernels, biases):
    """Differentiable SA with given indices: kernel 9 forward on CUDA
    tensors (idx int32), the plain version on CPU tensors; the backward is
    sa_from_idx_backward on either."""
    return _FusedSAIdx.apply(xyz, features, new_xyz, idx, len(kernels),
                             *kernels, *biases)
