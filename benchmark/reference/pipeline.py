"""Batched two-stage inference in plain tensor code (PointRCNN's and
WS3D's, as the measured program is configured to run it):

1. stage 1 on every scene: per-point scores and centre votes;
2. proposals: score > RPN.SCORE_THRESH and vote distance > 0.2 m, the top
   512 by score, greedy radius-0.3 m NMS, the top K centres; the slots in
   stable z order, empty slots last holding the running-max centre;
3. the 4 m BEV crop of 512 points around each slot (grouped-duplicate
   slots), recentred, y shifted by -1.65, the mask (score > 0.5) - 0.5;
4. the RCNN trunk on every slot; the IOUN cascade on the top
   round8(B * IOUN_BUDGET_PER_SCENE) slots of the batch by trunk score
   among those whose sigmoid passes RCNN.SCORE_THRESH (the others keep the
   trunk box with IoU score -inf, and are counted in `spilled` where they
   passed the gate);
5. un-centre, score = predicted IoU, keep = live & cls gate & IoU >
   IOUN.SCORE_THRESH & car-size gate, then a greedy 2-D IoU > 0.01
   self-NMS in descending score order.

Each stage runs in blocks of scenes or crops so that it fits on the card.
"""
from __future__ import annotations

import torch

from benchmark.reference import ops
from benchmark.reference.box_codec import decode_center
from benchmark.reference.iou3d import boxes_iou3d
from benchmark.reference.net import Net, angle_wrap, cat_blocks

GROUND_Y = 1.65
MIN_VOTE_DIST = 0.2
RADIUS_NMS = 0.3
CROP_RADIUS = 4.0
PRE_NMS_TOP = 512
SELF_NMS_IOU = 0.01
SIZE_GATE = ((1.1, 2.3), (1.2, 2.1), (2.1, 5.1))
SCENE_BLOCK = 8
CROP_BLOCK = 512


def propose(cfg: dict, rpn_cls, rpn_reg, xyz, K: int):
    """-> centres (B, K, 2), scores (B, K), valid (B, K) in z order."""
    r = cfg["RPN"]
    rois = decode_center(xyz, rpn_reg, r["LOC_SCOPE"], r["LOC_BIN_SIZE"])
    vote = torch.sqrt(torch.square(rois[..., 0] - xyz[..., 0])
                      + torch.square(rois[..., 2] - xyz[..., 2]))
    mask = (torch.sigmoid(rpn_cls) > r["SCORE_THRESH"]) & \
        (vote > MIN_VOTE_DIST)
    top_s, top_i = ops.top_k(torch.where(mask, rpn_cls, -torch.inf),
                             min(PRE_NMS_TOP, rpn_cls.shape[1]))
    top_valid = torch.isfinite(top_s)
    centers = ops.take(rois[..., [0, 2]], top_i)
    d = torch.sqrt(torch.sum(torch.square(centers[:, :, None]
                                          - centers[:, None]), dim=-1))
    keep = ops.greedy_suppress(-(d - RADIUS_NMS), 0.0, top_valid)
    sel_s, sel = ops.top_k(torch.where(keep, top_s, -torch.inf), K)
    valid = torch.isfinite(sel_s)
    centers = torch.where(valid[..., None], ops.take(centers, sel), 0.0)
    scores = torch.where(valid, sel_s, 0.0)
    # stable z order; invalid slots last, holding the running-max centre
    order = torch.sort(torch.where(valid, centers[..., 1], torch.inf),
                       dim=1, stable=True).indices
    cx = torch.gather(centers[..., 0], 1, order)
    cz = torch.gather(centers[..., 1], 1, order)
    valid = torch.gather(valid, 1, order)
    fx = torch.cummax(torch.where(valid, cx, -1e6), dim=1).values
    fz = torch.cummax(torch.where(valid, cz, -1e6), dim=1).values
    centers = torch.stack([torch.where(valid, cx, fx),
                           torch.where(valid, cz, fz)], dim=-1)
    return centers, torch.gather(scores, 1, order), valid


def crops(pts, rpn_cls, centers, k: int):
    """-> dict of (B, K, k, .) crop tensors, empty (B, K)."""
    ch = torch.stack([pts[..., 0], pts[..., 1], pts[..., 2], pts[..., 3],
                      torch.sigmoid(rpn_cls)], dim=-1)
    vals, cnt = ops.bev_crop(pts[..., 0:3], ch, centers, CROP_RADIUS, k)
    empty = cnt == 0
    xyz = torch.stack([vals[..., 0] - centers[..., 0:1],
                       vals[..., 1] - GROUND_Y,
                       vals[..., 2] - centers[..., 1:2]], dim=-1)
    mask = (vals[..., 4] > 0.5).float()[..., None] - 0.5
    z = empty[:, :, None, None]
    return {"pts": torch.where(z, 0.0, xyz),
            "reflect": torch.where(z, 0.0, vals[..., 3:4]),
            "mask": torch.where(z, 0.0, mask)}, empty


def finalize(boxes, cls, iou, centers, live, rcnn_thresh, iou_thresh):
    """-> boxes (B, K, 7) scene frame, scores (B, K), keep (B, K)."""
    out = torch.stack([boxes[..., 0] + centers[..., 0],
                       boxes[..., 1] + GROUND_Y,
                       boxes[..., 2] + centers[..., 1],
                       boxes[..., 3], boxes[..., 4], boxes[..., 5],
                       angle_wrap(boxes[..., 6])], dim=-1)
    keep = live & (torch.sigmoid(cls) > rcnn_thresh) & (iou > iou_thresh)
    h, w, l = out[..., 3], out[..., 4], out[..., 5]
    keep &= ((h > SIZE_GATE[0][0]) & (h < SIZE_GATE[0][1])
             & (w > SIZE_GATE[1][0]) & (w < SIZE_GATE[1][1])
             & (l > SIZE_GATE[2][0]) & (l < SIZE_GATE[2][1]))
    order = torch.argsort(-torch.where(keep, iou, -torch.inf), dim=-1,
                          stable=True)
    sorted_boxes = ops.take(out, order)
    iou2d, _ = boxes_iou3d(sorted_boxes, sorted_boxes)
    keep_sorted = ops.greedy_suppress(iou2d - SELF_NMS_IOU, 0.0,
                                      torch.gather(keep, 1, order))
    return out, iou, torch.gather(keep_sorted, 1, torch.argsort(order,
                                                                dim=-1))


@torch.no_grad()
def two_stage(net: Net, cfg: dict, pts: torch.Tensor) -> dict:
    """pts (B, N, 4) z-sorted scenes -> boxes (B, K, 7), scores (B, K),
    keep (B, K), centers (B, K, 2), proposal_valid (B, K), n_live (),
    spilled ()."""
    tpu, rcnn, ioun = cfg["TPU"], cfg["RCNN"], cfg["IOUN"]
    B = pts.shape[0]
    K = int(tpu["MAX_PROPOSALS"])
    k = int(rcnn["NUM_POINTS"])

    def stage1(lo, hi):
        p = pts[lo:hi]
        out = net.rpn(p)
        c, s, v = propose(cfg, out["rpn_cls"], out["rpn_reg"],
                          p[..., 0:3], K)
        cr, empty = crops(p, out["rpn_cls"], c, k)
        return {"centers": c, "scores": s, "valid": v, "empty": empty,
                **cr}

    s1 = cat_blocks(stage1, B, SCENE_BLOCK)
    live = (s1["valid"] & ~s1["empty"]).reshape(B * K)
    flat = {n: s1[n].reshape((B * K,) + s1[n].shape[2:])
            for n in ("pts", "reflect", "mask")}

    def trunk(lo, hi):
        t = net.trunk(flat["pts"][lo:hi], flat["reflect"][lo:hi],
                      flat["mask"][lo:hi])
        return {"cls": t["rcnn_cls"], "boxes": t["pred_boxes3d"]}

    t = cat_blocks(trunk, B * K, CROP_BLOCK)
    cls, boxes = t["cls"], t["boxes"].clone()
    iou = torch.full((B * K,), -torch.inf, device=pts.device)
    spilled = torch.zeros((), dtype=torch.int64, device=pts.device)
    budget = int(tpu.get("IOUN_BUDGET_PER_SCENE", 0))
    V2 = min(max(8, (B * budget + 7) // 8 * 8), B * K) if budget > 0 \
        else B * K
    gate = live & (torch.sigmoid(cls) > rcnn["SCORE_THRESH"])
    if V2 < B * K:
        _, sel = ops.top_k(torch.where(gate, cls, -torch.inf), V2)
        spilled = gate.sum() - gate[sel].sum()
    else:
        sel = torch.arange(B * K, device=pts.device)

    def cascade(lo, hi):
        rows = sel[lo:hi]
        c = net.cascade(flat["pts"][rows], flat["reflect"][rows],
                        flat["mask"][rows], t["boxes"][rows])
        return {"box": c["refined_box"], "iou": c["rcnn_iou"]}

    c = cat_blocks(cascade, sel.shape[0], CROP_BLOCK)
    boxes[sel] = c["box"]
    iou[sel] = c["iou"]
    out, scores, keep = finalize(
        boxes.reshape(B, K, 7), cls.reshape(B, K), iou.reshape(B, K),
        s1["centers"], live.reshape(B, K), rcnn["SCORE_THRESH"],
        ioun["SCORE_THRESH"])
    return {"boxes": out, "scores": scores, "keep": keep,
            "centers": s1["centers"], "proposal_valid": s1["valid"],
            "n_live": live.sum(), "spilled": spilled}


def kitti_rows(boxes, scores, keep, image_shape, fu=700.0, cu=600.0,
               cv=180.0):
    """The detections of one scene as a KITTI txt file lists them: kept
    boxes whose projected 2-D box (identity calibration, clipped to the
    image) covers at most 80 % of it in either side -> (n, 8) float64
    [x, y, z, h, w, l, ry, score]."""
    import numpy as np
    from benchmark.gen.kitti_min import boxes3d_to_corners3d_np
    b = np.asarray(boxes, np.float32)[np.asarray(keep)]
    s = np.asarray(scores, np.float32)[np.asarray(keep)]
    if b.shape[0] == 0:
        return np.zeros((0, 8))
    c = boxes3d_to_corners3d_np(b).astype(np.float64)
    u = fu * c[..., 0] / c[..., 2] + cu
    v = fu * c[..., 1] / c[..., 2] + cv
    u = np.clip(np.stack([u.min(1), u.max(1)], 1), 0, image_shape[1] - 1)
    v = np.clip(np.stack([v.min(1), v.max(1)], 1), 0, image_shape[0] - 1)
    ok = ((u[:, 1] - u[:, 0] < image_shape[1] * 0.8)
          & (v[:, 1] - v[:, 0] < image_shape[0] * 0.8))
    return np.concatenate([b[ok], s[ok, None]], axis=1).astype(np.float64)

