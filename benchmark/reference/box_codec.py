"""Frozen copy of the port's bin-based box decode (box_codec.py). Boxes
are (x, y, z, h, w, l, ry), bottom-y unless named otherwise."""
from __future__ import annotations

import math

import torch


def _gather_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., K), idx (...) -> (...) pick along the last axis."""
    return torch.gather(x, -1, idx[..., None]).squeeze(-1)


def decode_center(roi_center: torch.Tensor, pred_reg: torch.Tensor,
                  loc_scope: float, loc_bin_size: float) -> torch.Tensor:
    """Per-point centre vote decode (RPN): (..., 3), (..., 4n) -> (..., 3)
    with y = 0; residual scale loc_bin_size / 2."""
    n = int(loc_scope / loc_bin_size) * 2
    x_bin = torch.argmax(pred_reg[..., 0:n], dim=-1)
    z_bin = torch.argmax(pred_reg[..., n:2 * n], dim=-1)
    dtype = pred_reg.dtype
    pos_x = x_bin.to(dtype) * loc_bin_size + loc_bin_size / 2 - loc_scope
    pos_z = z_bin.to(dtype) * loc_bin_size + loc_bin_size / 2 - loc_scope
    x_res = _gather_last(pred_reg[..., 2 * n:3 * n], x_bin) * (loc_bin_size / 2)
    z_res = _gather_last(pred_reg[..., 3 * n:4 * n], z_bin) * (loc_bin_size / 2)
    pos_x = pos_x + x_res + roi_center[..., 0]
    pos_z = pos_z + z_res + roi_center[..., 2]
    return torch.stack([pos_x, torch.zeros_like(pos_x), pos_z], dim=-1)


def decode_box_stage2(roi_center: torch.Tensor, pred_reg: torch.Tensor,
                      anchor_size: torch.Tensor, loc_scope: float,
                      loc_bin_size: float, num_head_bin: int) -> torch.Tensor:
    """Stage-2 7-DoF decode as the RCNN trunk runs it (coarse x/z from the
    first residual slot, raw y offset, coarse heading bin + residual,
    anchor-relative size) -> (..., 7) [x, y, z, h, w, l, ry], bottom-y."""
    n = int(loc_scope / loc_bin_size) * 2
    pos_x = pred_reg[..., n * 2] * loc_scope
    pos_z = pred_reg[..., n * 3] * loc_scope
    start = n * 4
    pos_y = pred_reg[..., start]
    start += 1
    ry_bin = torch.argmax(pred_reg[..., start:start + num_head_bin], dim=-1)
    ry_res_norm = _gather_last(
        pred_reg[..., start + num_head_bin:start + 2 * num_head_bin], ry_bin)
    per = 2 * math.pi / num_head_bin
    ry = torch.remainder(ry_bin.to(pred_reg.dtype) * per
                         + ry_res_norm * (per / 2), 2 * math.pi)
    ry = torch.where(ry > math.pi, ry - 2 * math.pi, ry)
    start += 2 * num_head_bin
    hwl = pred_reg[..., start:start + 3] * anchor_size + anchor_size
    pos_x = pos_x + roi_center[..., 0]
    pos_z = pos_z + roi_center[..., 2]
    return torch.cat([pos_x[..., None], pos_y[..., None], pos_z[..., None],
                      hwl, ry[..., None]], dim=-1)


def refine_box(boxes: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """centre += dims * ref[:3]; dims *= (1 + ref[3:6]); ry += ref[6]."""
    center = boxes[..., 0:3] + boxes[..., 3:6] * ref[..., 0:3]
    dims = boxes[..., 3:6] * (1.0 + ref[..., 3:6])
    ry = boxes[..., 6:7] + ref[..., 6:7]
    return torch.cat([center, dims, ry], dim=-1)


def center_to_bottom(boxes: torch.Tensor) -> torch.Tensor:
    """Centre-y box -> bottom-y box; ry wrapped to [0, 2pi)."""
    y = boxes[..., 1:2] + boxes[..., 3:4] / 2
    ry = torch.remainder(boxes[..., 6:7], 2 * math.pi)
    return torch.cat([boxes[..., 0:1], y, boxes[..., 2:3], boxes[..., 3:6],
                      ry], dim=-1)


def bottom_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """Bottom-y box -> centre-y box."""
    y = boxes[..., 1:2] - boxes[..., 3:4] / 2
    return torch.cat([boxes[..., 0:1], y, boxes[..., 2:3], boxes[..., 3:7]],
                     dim=-1)
