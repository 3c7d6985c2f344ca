"""Rotated BEV overlap / IoU over a fixed 24-vertex buffer (port of
ws3d_tpu/ops/iou3d.py). EPS 1e-8 and MARGIN 1e-5 as the reference."""
from __future__ import annotations

import torch

from ws3d_tpu_torch.ops.boxes import boxes3d_to_bev

EPS = 1e-8
MARGIN = 1e-5


def _corners_xy(bev: torch.Tensor):
    """bev (P, 5) -> corner planes (P, 4), (P, 4)."""
    x1, y1, x2, y2, ang = bev.unbind(-1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    dx = torch.stack([x1 - cx, x2 - cx, x2 - cx, x1 - cx], dim=-1)
    dy = torch.stack([y1 - cy, y1 - cy, y2 - cy, y2 - cy], dim=-1)
    c, s = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    return dx * c + dy * s + cx[:, None], -dx * s + dy * c + cy[:, None]


def _point_in_bev_xy(bev: torch.Tensor, px: torch.Tensor, py: torch.Tensor):
    x1, y1, x2, y2, ang = bev.unbind(-1)
    cx, cy = ((x1 + x2) / 2)[:, None], ((y1 + y2) / 2)[:, None]
    c = torch.cos(-ang)[:, None]
    s = torch.sin(-ang)[:, None]
    rx = (px - cx) * c + (py - cy) * s + cx
    ry = -(px - cx) * s + (py - cy) * c + cy
    return ((rx > x1[:, None] - MARGIN) & (rx < x2[:, None] + MARGIN)
            & (ry > y1[:, None] - MARGIN) & (ry < y2[:, None] + MARGIN))


def _cross3_xy(p1x, p1y, p2x, p2y, p0x, p0y):
    return (p1x - p0x) * (p2y - p0y) - (p2x - p0x) * (p1y - p0y)


def _edge_intersections_xy(cax, cay, cbx, cby):
    """Corner loops (P, 4) x2 -> intersections x/y (P, 16) + valid (P, 16)."""
    def expand(cx, cy):
        return (cx.repeat_interleave(4, -1), cy.repeat_interleave(4, -1),
                torch.roll(cx, -1, -1).repeat_interleave(4, -1),
                torch.roll(cy, -1, -1).repeat_interleave(4, -1))

    a0x, a0y, a1x, a1y = expand(cax, cay)
    b0x, b0y = cbx.repeat(1, 4), cby.repeat(1, 4)
    b1x = torch.roll(cbx, -1, -1).repeat(1, 4)
    b1y = torch.roll(cby, -1, -1).repeat(1, 4)

    rect = ((torch.minimum(a0x, a1x) <= torch.maximum(b0x, b1x))
            & (torch.minimum(b0x, b1x) <= torch.maximum(a0x, a1x))
            & (torch.minimum(a0y, a1y) <= torch.maximum(b0y, b1y))
            & (torch.minimum(b0y, b1y) <= torch.maximum(a0y, a1y)))
    s1 = _cross3_xy(b0x, b0y, a1x, a1y, a0x, a0y)
    s2 = _cross3_xy(a1x, a1y, b1x, b1y, a0x, a0y)
    s3 = _cross3_xy(a0x, a0y, b1x, b1y, b0x, b0y)
    s4 = _cross3_xy(b1x, b1y, a1x, a1y, b0x, b0y)
    valid = rect & (s1 * s2 > 0) & (s3 * s4 > 0)

    s5 = _cross3_xy(b1x, b1y, a1x, a1y, a0x, a0y)
    denom = s5 - s1
    primary = torch.abs(denom) > EPS
    safe = torch.where(primary, denom, 1.0)
    ix1 = (s5 * b0x - s1 * b1x) / safe
    iy1 = (s5 * b0y - s1 * b1y) / safe

    la0, lb0 = a0y - a1y, a1x - a0x
    lc0 = a0x * a1y - a1x * a0y
    la1, lb1 = b0y - b1y, b1x - b0x
    lc1 = b0x * b1y - b1x * b0y
    D = la0 * lb1 - la1 * lb0
    Dsafe = torch.where(torch.abs(D) > 0, D, 1.0)
    ix2 = (lb0 * lc1 - lb1 * lc0) / Dsafe
    iy2 = (la1 * lc0 - la0 * lc1) / Dsafe

    ix = torch.where(primary, ix1, ix2)
    iy = torch.where(primary, iy1, iy2)
    return (torch.where(valid, ix, 0.0), torch.where(valid, iy, 0.0), valid)


def _overlap_pairs(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A, B (..., 5) aligned pairs -> (...) intersection areas."""
    shape = A.shape[:-1]
    A = A.reshape(-1, 5)
    B = B.reshape(-1, 5)
    cax, cay = _corners_xy(A)
    cbx, cby = _corners_xy(B)
    ix, iy, inter_valid = _edge_intersections_xy(cax, cay, cbx, cby)
    a_in_b = _point_in_bev_xy(B, cax, cay)
    b_in_a = _point_in_bev_xy(A, cbx, cby)
    px = torch.cat([ix, torch.where(a_in_b, cax, 0.0),
                    torch.where(b_in_a, cbx, 0.0)], dim=-1)      # (P, 24)
    py = torch.cat([iy, torch.where(a_in_b, cay, 0.0),
                    torch.where(b_in_a, cby, 0.0)], dim=-1)
    valid = torch.cat([inter_valid, a_in_b, b_in_a], dim=-1)

    cnt = valid.sum(-1)
    denom = torch.clamp(cnt, min=1)
    cx = px.sum(-1) / denom
    cy = py.sum(-1) / denom
    ang = torch.atan2(py - cy[:, None], px - cx[:, None])
    ang = torch.where(valid, ang, 1e9)
    order = torch.sort(ang, dim=-1, stable=True).indices
    spx = torch.gather(px, -1, order)
    spy = torch.gather(py, -1, order)
    sv = torch.gather(valid, -1, order)
    poly_x = torch.where(sv, spx, spx[:, 0:1])
    poly_y = torch.where(sv, spy, spy[:, 0:1])
    nxt_x = torch.roll(poly_x, -1, -1)
    nxt_y = torch.roll(poly_y, -1, -1)
    area = torch.abs(torch.sum(poly_x * nxt_y - nxt_x * poly_y, -1)) / 2.0
    return torch.where(cnt >= 3, area, 0.0).reshape(shape)


def rotated_overlap_bev(bev_a: torch.Tensor,
                        bev_b: torch.Tensor) -> torch.Tensor:
    """(..., M, 5) x (..., N, 5) -> (..., M, N) intersection areas."""
    M, N = bev_a.shape[-2], bev_b.shape[-2]
    lead = torch.broadcast_shapes(bev_a.shape[:-2], bev_b.shape[:-2])
    A = bev_a[..., :, None, :].expand(lead + (M, N, 5))
    B = bev_b[..., None, :, :].expand(lead + (M, N, 5))
    return _overlap_pairs(A, B)


def boxes_iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor):
    """(..., N, 7) x (..., M, 7) bottom-y boxes -> (iou2d, iou3d) (..., N, M)."""
    overlaps_bev = rotated_overlap_bev(boxes3d_to_bev(boxes_a),
                                       boxes3d_to_bev(boxes_b))
    a_min = (boxes_a[..., 1] - boxes_a[..., 3])[..., :, None]
    a_max = boxes_a[..., 1][..., :, None]
    b_min = (boxes_b[..., 1] - boxes_b[..., 3])[..., None, :]
    b_max = boxes_b[..., 1][..., None, :]
    overlaps_h = torch.clamp(torch.minimum(a_max, b_max)
                             - torch.maximum(a_min, b_min), min=0.0)
    s_a = (boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    s_b = (boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    iou2d = overlaps_bev / torch.clamp(s_a + s_b - overlaps_bev, min=1e-7)
    overlaps_3d = overlaps_bev * overlaps_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    iou3d = overlaps_3d / torch.clamp(vol_a + vol_b - overlaps_3d, min=1e-7)
    return iou2d, iou3d
