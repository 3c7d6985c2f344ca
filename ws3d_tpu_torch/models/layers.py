"""Channel-last layers (port of ws3d_tpu/models/layers.py), eval only.

Parameters keep the JAX package's names and layouts so the flat npz keys
map one to one: ``Dense_k.kernel`` is (Cin, Cout), ``BatchNorm_k`` holds
``scale``/``bias`` parameters and ``mean``/``var`` buffers (eps 1e-5).
Dropout is off at inference and has no module here.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from ws3d_tpu_torch.ops.fused_sa import pack_params

BN_EPS = 1e-5


class Dense(nn.Module):
    def __init__(self, cin: int, cout: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.kernel)
        return y if self.bias is None else y + self.bias


class BatchNorm(nn.Module):
    """Inference BatchNorm over the trailing channel axis."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.reciprocal(torch.sqrt(self.var + BN_EPS))
        return (x - self.mean) * inv * self.scale + self.bias


class SharedMLP(nn.Module):
    """Dense(+BN)+ReLU stack over the trailing channel axis."""

    def __init__(self, cin: int, channels: Sequence[int], use_bn: bool = True):
        super().__init__()
        self.channels = [int(c) for c in channels]
        self.use_bn = use_bn
        for k, c in enumerate(self.channels):
            self.add_module(f"Dense_{k}", Dense(cin, c, use_bias=not use_bn))
            if use_bn:
                self.add_module(f"BatchNorm_{k}", BatchNorm(c))
            cin = c
        self._fold_key = None
        self._fold = None
        self._packed = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(len(self.channels)):
            x = getattr(self, f"Dense_{k}")(x)
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{k}")(x)
            x = torch.relu(x)
        return x

    def folded(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """folded_mlp_params(self), made once per state of the weights.

        The cache is keyed by every parameter's and buffer's storage and
        version counter, so load_state_dict, in-place edits and .to() refold.
        With autograd on, the fold is made afresh on every call."""
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
    """Hidden Dense(+BN)+ReLU layers, then a linear output layer."""

    def __init__(self, cin: int, hidden: Sequence[int], out_channels: int,
                 use_bn: bool = True):
        super().__init__()
        self.n_hidden = len(hidden)
        self.use_bn = use_bn
        for i, c in enumerate(hidden):
            self.add_module(f"Dense_{i}", Dense(cin, c, use_bias=not use_bn))
            if use_bn:
                self.add_module(f"BatchNorm_{i}", BatchNorm(c))
            cin = c
        self.add_module(f"Dense_{self.n_hidden}", Dense(cin, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f"Dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = torch.relu(x)
        return getattr(self, f"Dense_{self.n_hidden}")(x)


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
