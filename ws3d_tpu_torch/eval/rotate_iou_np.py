"""Rotated-rectangle overlap for the KITTI AP harness, vectorised NumPy: all
(N, K) box pairs evaluate a fixed 24-candidate vertex buffer (16 edge-edge
intersections and 2 x 4 corner containment tests), then an angle sort and
the shoelace formula. Copy of ws3d_tpu/eval/rotate_iou_np.py.

Box format: (cx, cz, w, h, angle), centre, extents and rotation (for BEV
built from KITTI camera boxes as [x, z, l, w, ry]).
"""
from __future__ import annotations

import numpy as np

EPS = 1e-8


def _corners(boxes: np.ndarray) -> np.ndarray:
    """(..., 5) -> (..., 4, 2) corner loop of the rotated rect."""
    cx, cy, w, h, ang = (boxes[..., 0], boxes[..., 1], boxes[..., 2],
                         boxes[..., 3], boxes[..., 4])
    dx = np.stack([-w / 2, w / 2, w / 2, -w / 2], axis=-1)
    dy = np.stack([-h / 2, -h / 2, h / 2, h / 2], axis=-1)
    c, s = np.cos(ang)[..., None], np.sin(ang)[..., None]
    px = dx * c - dy * s + cx[..., None]
    py = dx * s + dy * c + cy[..., None]
    return np.stack([px, py], axis=-1)


def _cross(o, a, b):
    return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
            - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))


def _point_in_quad(pts: np.ndarray, quad: np.ndarray) -> np.ndarray:
    """pts (..., P, 2), quad (..., 4, 2) convex ccw/cw loop -> (..., P) bool."""
    inside = None
    sign_ref = None
    for i in range(4):
        a = quad[..., i, :][..., None, :]
        b = quad[..., (i + 1) % 4, :][..., None, :]
        cr = _cross(a, b, pts)
        s = cr >= -1e-9
        s2 = cr <= 1e-9
        inside = s if inside is None else (inside & s)
        sign_ref = s2 if sign_ref is None else (sign_ref & s2)
    return inside | sign_ref


def _edge_intersections(ca: np.ndarray, cb: np.ndarray):
    """ca, cb (..., 4, 2) -> pts (..., 16, 2), valid (..., 16)."""
    a0 = np.repeat(ca, 4, axis=-2)
    a1 = np.repeat(np.roll(ca, -1, axis=-2), 4, axis=-2)
    reps = (1,) * (cb.ndim - 2) + (4, 1)
    b0 = np.tile(cb, reps)
    b1 = np.tile(np.roll(cb, -1, axis=-2), reps)

    d1 = a1 - a0
    d2 = b1 - b0
    denom = d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0]
    ok = np.abs(denom) > EPS
    safe = np.where(ok, denom, 1.0)
    diff = b0 - a0
    t = (diff[..., 0] * d2[..., 1] - diff[..., 1] * d2[..., 0]) / safe
    u = (diff[..., 0] * d1[..., 1] - diff[..., 1] * d1[..., 0]) / safe
    valid = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = a0 + t[..., None] * d1
    return np.where(valid[..., None], pts, 0.0), valid


def rotated_inter_area(boxes: np.ndarray, qboxes: np.ndarray) -> np.ndarray:
    """(N, 5) x (K, 5) -> (N, K) intersection areas of rotated rects."""
    N, K = boxes.shape[0], qboxes.shape[0]
    if N == 0 or K == 0:
        return np.zeros((N, K), np.float64)
    A = np.broadcast_to(boxes[:, None, :], (N, K, 5))
    B = np.broadcast_to(qboxes[None, :, :], (N, K, 5))
    ca = _corners(A)
    cb = _corners(B)
    ipts, ivalid = _edge_intersections(ca, cb)
    a_in_b = _point_in_quad(ca, cb)
    b_in_a = _point_in_quad(cb, ca)
    pts = np.concatenate([ipts,
                          np.where(a_in_b[..., None], ca, 0.0),
                          np.where(b_in_a[..., None], cb, 0.0)], axis=-2)
    valid = np.concatenate([ivalid, a_in_b, b_in_a], axis=-1)   # (N, K, 24)

    cnt = valid.sum(axis=-1)
    center = pts.sum(axis=-2) / np.maximum(cnt, 1)[..., None]
    ang = np.arctan2(pts[..., 1] - center[..., None, 1],
                     pts[..., 0] - center[..., None, 0])
    ang = np.where(valid, ang, 1e9)
    order = np.argsort(ang, axis=-1)
    spts = np.take_along_axis(pts, order[..., None], axis=-2)
    svalid = np.take_along_axis(valid, order, axis=-1)
    first = spts[..., 0:1, :]
    poly = np.where(svalid[..., None], spts, first)
    nxt = np.roll(poly, -1, axis=-2)
    area = np.abs((poly[..., 0] * nxt[..., 1]
                   - nxt[..., 0] * poly[..., 1]).sum(axis=-1)) / 2.0
    return np.where(cnt >= 3, area, 0.0)


def rotate_iou_eval(boxes: np.ndarray, qboxes: np.ndarray,
                    criterion: int = -1) -> np.ndarray:
    """rotate_iou_gpu_eval semantics: criterion -1 => IoU, 0 => inter/area1,
    1 => inter/area2, else => raw intersection area."""
    inter = rotated_inter_area(boxes, qboxes)
    if criterion == -1:
        a1 = (boxes[:, 2] * boxes[:, 3])[:, None]
        a2 = (qboxes[:, 2] * qboxes[:, 3])[None, :]
        return inter / np.maximum(a1 + a2 - inter, EPS)
    if criterion == 0:
        return inter / np.maximum((boxes[:, 2] * boxes[:, 3])[:, None], EPS)
    if criterion == 1:
        return inter / np.maximum((qboxes[:, 2] * qboxes[:, 3])[None, :], EPS)
    return inter
