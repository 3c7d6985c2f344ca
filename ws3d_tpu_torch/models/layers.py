"""Channel-last layers (port of ws3d_tpu/models/layers.py).

Parameters keep the JAX package's names and layouts so the flat npz keys
map one to one: ``Dense_k.kernel`` is (Cin, Cout), ``BatchNorm_k`` holds
``scale``/``bias`` parameters and ``mean``/``var`` buffers (eps 1e-5).
Train mode is an argument of each forward, as in the JAX package: BatchNorm
then normalises with the batch statistics and updates its running ones with
the momentum it is given, and HeadMLP applies dropout drawn from the
caller's torch.Generator.

`dtype=torch.bfloat16` is the JAX package's compute dtype (flax
``nn.Dense(dtype=bfloat16)``): a Dense layer rounds its input and kernel to
bf16, sums the products in f32 and returns bf16, the bias added in bf16;
BatchNorm upcasts to f32 first; SharedMLP returns f32 unless `out_f32` is
False; HeadMLP's last layer is f32 on an f32 input. Parameters, BatchNorm
statistics and the folded weights stay f32.

Train-mode BatchNorm + ReLU on the card runs on hand-written kernels
(BatchNorm.relu, ops/batchnorm.py), in a global batch of several ranks
too; on CPU tensors it stays the composition below.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ws3d_tpu_torch.ops import batchnorm
from ws3d_tpu_torch.ops.fused_sa import pack_params
from ws3d_tpu_torch.ops.fused_sa_idx import dense_bf16
from ws3d_tpu_torch.parallel import global_batch

BN_EPS = 1e-5


class Dense(nn.Module):
    """x @ kernel + bias; with dtype bf16, flax's Dense(dtype=bfloat16):
    the f32 sum of bf16 products rounded to bf16, plus the bias in bf16."""

    def __init__(self, cin: int, cout: int, use_bias: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            y = torch.matmul(x, self.kernel)
            return y if self.bias is None else y + self.bias
        return dense_bf16(x, self.kernel, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis.

    train=True normalises with the mean and the biased variance over all
    leading axes and updates running = (1 - m) * running + m * batch, the
    variance biased too (nn.BatchNorm would store the unbiased one). Inside
    parallel.data_parallel_jit the statistics are the whole global batch's
    (parallel.global_batch.mean_var)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False,
                momentum: float = 0.1) -> torch.Tensor:
        mean, var = self._statistics(x, train, momentum)
        inv = torch.reciprocal(torch.sqrt(var + BN_EPS))
        return (x - mean) * inv * self.scale + self.bias

    def relu(self, x: torch.Tensor, train: bool = False,
             momentum: float = 0.1) -> torch.Tensor:
        """torch.relu(self(x, train, momentum)). In train mode on a CUDA
        tensor the statistics (a global batch's in a global batch) are
        taken without autograd and ops.batchnorm.bn_relu_train runs the
        rest: the same output and running statistics bit for bit, the
        gradient by its formula."""
        if not (train and x.is_cuda):
            return torch.relu(self(x, train, momentum))
        with torch.no_grad():
            mean, var = self._statistics(x, True, momentum)
            inv = torch.reciprocal(torch.sqrt(var + BN_EPS))
        return batchnorm.bn_relu_train(x, mean, inv, self.scale, self.bias)

    def _statistics(self, x: torch.Tensor, train: bool, momentum: float):
        """(mean, var) to normalise with: the batch's, with the running
        ones updated, in train mode; the running ones in eval."""
        if not train:
            return self.mean, self.var
        mean, var = global_batch.mean_var(x)
        with torch.no_grad():
            m = float(momentum)
            self.mean.copy_((1 - m) * self.mean + m * mean)
            self.var.copy_((1 - m) * self.var + m * var)
        return mean, var


class SharedMLP(nn.Module):
    """Dense(+BN)+ReLU stack over the trailing channel axis. With a bf16
    `dtype` the output is f32 unless `out_f32` is False (the BN-free
    stage-2 up/merge chains keep bf16)."""

    def __init__(self, cin: int, channels: Sequence[int], use_bn: bool = True,
                 dtype: Optional[torch.dtype] = None, out_f32: bool = True):
        super().__init__()
        self.channels = [int(c) for c in channels]
        self.use_bn = use_bn
        self.dtype = dtype
        self.out_f32 = out_f32
        for k, c in enumerate(self.channels):
            self.add_module(f"Dense_{k}", Dense(cin, c, use_bias=not use_bn,
                                                dtype=dtype))
            if use_bn:
                self.add_module(f"BatchNorm_{k}", BatchNorm(c))
            cin = c
        self._fold_key = None
        self._fold = None
        self._packed = None

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.1) -> torch.Tensor:
        for k in range(len(self.channels)):
            x = getattr(self, f"Dense_{k}")(x)
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{k}").relu(x.float(), train,
                                                         bn_momentum)
            else:
                x = torch.relu(x)
        return x.float() if self.out_f32 else x

    def folded(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """folded_mlp_params(self), made once per state of the weights.

        The cache is keyed by every parameter's and buffer's storage and
        version counter, so load_state_dict, in-place edits and .to() refold.
        With autograd on, the fold is made afresh on every call. The fold
        uses the running statistics: eval only, never a train-mode
        forward."""
        if torch.is_grad_enabled():
            return folded_mlp_params(self)
        key = tuple((t.data_ptr(), t._version)
                    for t in (*self.parameters(), *self.buffers()))
        if key != self._fold_key:
            self._fold = folded_mlp_params(self)
            self._packed = None
            self._fold_key = key
        return self._fold

    def packed(self) -> torch.Tensor:
        """The folded weights as the fused-SA kernel's single f32 buffer
        (ops.fused_sa.pack_params), cached with the fold."""
        kernels, biases = self.folded()
        if torch.is_grad_enabled():
            return pack_params(kernels, biases)
        if self._packed is None:
            self._packed = pack_params(kernels, biases)
        return self._packed


class HeadMLP(nn.Module):
    """Hidden Dense(+BN)+ReLU layers (in `dtype`), then a linear f32 output
    layer. In train mode, dropout with rate `dp_ratio` after the ReLU of
    hidden layer 0 (inverted: kept values scale by 1 / (1 - p))."""

    def __init__(self, cin: int, hidden: Sequence[int], out_channels: int,
                 use_bn: bool = True, dp_ratio: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_hidden = len(hidden)
        self.use_bn = use_bn
        self.dp_ratio = float(dp_ratio)
        for i, c in enumerate(hidden):
            self.add_module(f"Dense_{i}", Dense(cin, c, use_bias=not use_bn,
                                                dtype=dtype))
            if use_bn:
                self.add_module(f"BatchNorm_{i}", BatchNorm(c))
            cin = c
        self.add_module(f"Dense_{self.n_hidden}", Dense(cin, out_channels))

    def forward(self, x: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f"Dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{i}").relu(x.float(), train,
                                                         bn_momentum)
            else:
                x = torch.relu(x)
            if i == 0 and train and self.dp_ratio > 0:
                x = dropout(x, self.dp_ratio, generator)
        return getattr(self, f"Dense_{self.n_hidden}")(x.float())


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout as flax.linen.Dropout: keep with probability 1 - p,
    kept values divided by 1 - p. Draws from `generator` (on x's device);
    inside parallel.data_parallel_jit the mask of the whole global batch,
    of which the rank keeps its rows (x batch-leading)."""
    if generator is None:
        raise ValueError("train-mode dropout needs a torch.Generator")
    keep = global_batch.rows(x.shape, lambda shape: torch.rand(
        shape, generator=generator, device=x.device)) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


def folded_mlp_params(mlp: SharedMLP) -> Tuple[List[torch.Tensor],
                                                List[torch.Tensor]]:
    """Dense kernels/biases of a SharedMLP with inference BN folded in:
    bn(x @ W) = x @ (W * s) + (beta - mean * s), s = scale / sqrt(var + eps)
    (ws3d_tpu/models/pointnet2.py:folded_mlp_params)."""
    kernels, biases = [], []
    for k in range(len(mlp.channels)):
        W = getattr(mlp, f"Dense_{k}").kernel
        if mlp.use_bn:
            bn = getattr(mlp, f"BatchNorm_{k}")
            inv = bn.scale * torch.rsqrt(bn.var + BN_EPS)
            kernels.append(W * inv[None, :])
            biases.append(bn.bias - bn.mean * inv)
        else:
            kernels.append(W)
            biases.append(getattr(mlp, f"Dense_{k}").bias)
    return kernels, biases
