"""Fused set abstraction (kernels 2 and 3: csrc/fused_sa.cu).

One function: ball query, gather of [xyz - q, feat] rows, the BN-folded
ReLU MLP and a max over the S samples. The CUDA source has two entry points:
the windowed one (ws3d_tpu/ops/fused_sa_window_pallas.py) scans only the
z-window of each query and requires points and queries sorted ascending by
z; the full one (ws3d_tpu/ops/fused_sa_bq_pallas.py) scans all points. The
plain version is the f32 composition of fused_sa_bq_pallas._xla_reference.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ws3d_tpu_torch.ops import _kernels
from ws3d_tpu_torch.ops.grouping import ball_query, group_with_idx

# slack added to the window half-width: every point outside [qz - win,
# qz + win] has dz^2 > r^2 even after f32 rounding, so the window drops none
_WINDOW_REL = 1e-5
_WINDOW_ABS = 1e-6


def fused_sa_plain(xyz, features, new_xyz, radius: float, nsample: int,
                   kernels: Sequence[torch.Tensor],
                   biases: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: ball query + group + dense stack + max over S."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    h = group_with_idx(idx, xyz, new_xyz, features)
    for k, b in zip(kernels, biases):
        h = torch.relu(torch.matmul(h, k) + b)
    return torch.amax(h, dim=2)


def pack_params(kernels, biases) -> torch.Tensor:
    """[W0, b0, W1, b1, ...] as one f32 buffer; each W (ci, co) row-major
    with zero rows appended up to a multiple of 4 (the kernel's row pad)."""
    parts = []
    for k, b in zip(kernels, biases):
        k = torch.nn.functional.pad(k, (0, 0, 0, (-k.shape[0]) % 4))
        parts += [k.reshape(-1), b.reshape(-1)]
    return torch.cat(parts).float().contiguous()


def fused_sa_cuda(xyz, features, new_xyz, radius: float, nsample: int,
                  kernels, biases, window: bool,
                  params: torch.Tensor | None = None) -> torch.Tensor:
    """Kernels 2 (window=True) and 3: (B, P, 3), (B, P, C), (B, M, 3) f32
    CUDA -> (B, M, C_last). `params` is pack_params(kernels, biases) made
    ahead by the caller, or None to pack here."""
    B, P, _ = xyz.shape
    M = new_xyz.shape[1]
    C = features.shape[-1]
    _kernels.check_cuda(xyz, "fused_sa xyz", torch.float32, (None, None, 3))
    _kernels.check_cuda(features, "fused_sa features", torch.float32,
                        (B, P, None))
    _kernels.check_cuda(new_xyz, "fused_sa new_xyz", torch.float32,
                        (B, None, 3))
    widths = [C + 3] + [int(k.shape[1]) for k in kernels]
    if any(w % 4 for w in widths[1:]):
        raise ValueError(f"fused_sa: layer widths {widths[1:]} must be "
                         f"multiples of 4")
    for i, (k, b) in enumerate(zip(kernels, biases)):
        if tuple(k.shape) != (widths[i], widths[i + 1]) or \
                tuple(b.shape) != (widths[i + 1],):
            raise ValueError(f"fused_sa layer {i}: kernel {tuple(k.shape)} "
                             f"bias {tuple(b.shape)} do not chain from "
                             f"{widths[i]}")
    if params is None:
        params = pack_params(kernels, biases)
    n_params = sum(-(-w // 4) * 4 * wo + wo
                   for w, wo in zip(widths[:-1], widths[1:]))
    _kernels.check_cuda(params, "fused_sa params", torch.float32, (n_params,))
    out = torch.empty((B, M, widths[-1]), dtype=torch.float32,
                      device=xyz.device)
    r = float(radius)
    widths_c = (_kernels.ctypes.c_int * len(widths))(*widths)
    rc = _kernels.library().ws3d_fused_sa(
        xyz.data_ptr(), features.data_ptr(), new_xyz.data_ptr(), B, P, C, M,
        r * r, r * (1.0 + _WINDOW_REL) + _WINDOW_ABS, int(nsample),
        int(bool(window)), len(kernels), widths_c, params.data_ptr(),
        out.data_ptr(), _kernels.stream_ptr(xyz))
    name = "fused_sa_window" if window else "fused_sa_full"
    _kernels.raise_on_error(rc, name)
    _kernels.LAUNCHES[name] += 1
    return out


def fused_sa(xyz, features, new_xyz, radius: float, nsample: int, kernels,
             biases, window: bool,
             params: torch.Tensor | None = None) -> torch.Tensor:
    """Set abstraction for one scale: the kernel on CUDA tensors, the plain
    version on CPU tensors. `window` requires z-sorted points and queries;
    `params` (the kernel's packed weights) is used only on CUDA."""
    if xyz.is_cuda:
        return fused_sa_cuda(xyz, features, new_xyz, radius, nsample,
                             kernels, biases, window, params=params)
    return fused_sa_plain(xyz, features, new_xyz, radius, nsample, kernels,
                          biases)
