"""PointNet spatial transformer, the T-Net (port of
ws3d_tpu/models/transformer.py): a K x K affine, identity at init, for
the point tensor. The reference builds it in its RCNN but never calls it;
it stays for standalone use. Module names follow the JAX module's (mlp,
fc_0, fc_1, fc_out), so weights.load_variables carries its variables.
"""
from __future__ import annotations

import torch
from torch import nn

from ws3d_tpu_torch.models.layers import Dense, SharedMLP


class Transformer(nn.Module):
    def __init__(self, k: int = 3, mlp_channels=(64, 128, 1024),
                 fc_channels=(512, 256), use_bn: bool = True, seed: int = 0):
        super().__init__()
        from ws3d_tpu_torch.models.detector import init_random
        self.k = k
        self.mlp = SharedMLP(k, mlp_channels, use_bn=use_bn)
        cin = int(mlp_channels[-1])
        self.n_fc = len(fc_channels)
        for i, c in enumerate(fc_channels):
            self.add_module(f"fc_{i}", Dense(cin, int(c)))
            cin = int(c)
        self.fc_out = Dense(cin, k * k)
        init_random(self, seed)
        with torch.no_grad():          # the identity transform at init
            self.fc_out.kernel.zero_()
            self.fc_out.bias.zero_()

    def forward(self, points: torch.Tensor, train: bool = False,
                bn_momentum: float = 0.1) -> torch.Tensor:
        """points (B, N, k) -> (B, k, k) transform."""
        g = torch.amax(self.mlp(points, train=train, bn_momentum=bn_momentum),
                       dim=1)
        for i in range(self.n_fc):
            g = torch.relu(getattr(self, f"fc_{i}")(g))
        eye = torch.eye(self.k, dtype=points.dtype,
                        device=points.device).reshape(1, -1)
        return (self.fc_out(g) + eye).reshape(-1, self.k, self.k)


def apply_transform(points: torch.Tensor,
                    transform: torch.Tensor) -> torch.Tensor:
    """points (B, N, k) @ transform (B, k, k) -> (B, N, k)."""
    return torch.matmul(points, transform)
