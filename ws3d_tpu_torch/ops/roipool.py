"""First-k in-mask selection with `s % cnt` wraparound (port of
ws3d_tpu/ops/roipool.py:_first_k_wraparound)."""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops.grouping import first_k_true_indices


def first_k_wraparound(mask: torch.Tensor, k: int):
    """mask (..., N) bool -> (idx (..., k) int64, empty (...,) bool): first-k
    true positions in ascending order, repeated cyclically when fewer."""
    N = mask.shape[-1]
    kk = min(k, N)
    sel = first_k_true_indices(mask, kk)
    cnt = mask.sum(-1)
    empty = cnt == 0
    slots = torch.arange(k, device=mask.device)
    wrap = torch.clamp(slots % torch.clamp(cnt, min=1)[..., None], max=kk - 1)
    idx = torch.gather(sel, -1, wrap)
    return torch.where(empty[..., None], 0, idx), empty
