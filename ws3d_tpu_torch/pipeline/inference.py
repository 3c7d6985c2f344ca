"""Batched two-stage inference (port of ws3d_tpu/pipeline/inference.py).

RPN forward -> per-point centre votes -> score/vote-distance gate -> top-M
preselect -> radius-0.3 greedy NMS -> top-K centres -> z-ordered slots ->
4 m cylinder crops (kernel 5) -> RCNN trunk -> IOUN cascade on the gate
survivors -> un-centre, score and car-size gate, self-NMS -> packed record.

crop_membership (kernel 6w) is the proposal database's crop: every point
within 4 m of a proposal, for tools/generate_box_dataset.

Ties follow the JAX package: ``lax.top_k`` and stable sorts put the lower
index first, so every top-k here is a stable descending sort.
"""
from __future__ import annotations

import math

import torch

from ws3d_tpu_torch.box_codec import decode_center
from ws3d_tpu_torch.ops.ball_query import ball_query_wrap
from ws3d_tpu_torch.ops.crop_gather import crop_gather
from ws3d_tpu_torch.ops.iou3d import boxes_iou3d
from ws3d_tpu_torch.ops.nms import greedy_suppress
from ws3d_tpu_torch.parallel.mesh import all_gather
from ws3d_tpu_torch.utils.profiling import span

GROUND_Y = 1.65
MIN_VOTE_DIST = 0.2
RADIUS_NMS = 0.3
CROP_RADIUS = 4.0
SELF_NMS_IOU = 0.01
SIZE_GATE = ((1.1, 2.3), (1.2, 2.1), (2.1, 5.1))
# where crop_membership moves invalid points: 1e6 m off on x and z, so no
# centre decoded from a scene's valid points (a point plus a vote bounded
# by LOC_SCOPE, or 0 for an empty slot) has one within the 4 m radius
FAR = 1.0e6


def top_k(x: torch.Tensor, k: int):
    """lax.top_k along the last axis: descending, lower index first on
    ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) gathered along axis 1 by idx (B, K)."""
    tail = x.shape[2:]
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * len(tail))
                        .expand(idx.shape + tail))


@span("inference.propose")
def rpn_propose(rpn_cls, rpn_reg, backbone_xyz, loc_scope: float,
                loc_bin_size: float, score_thresh: float = 0.3,
                pre_nms_top: int = 512, max_proposals: int = 64,
                nms_radius: float = RADIUS_NMS, point_valid=None):
    """Batched: (B, N, 1), (B, N, C), (B, N, 3) -> centers_xz (B, K, 2),
    scores_raw (B, K), valid (B, K), score-sorted. `point_valid` (B, N)
    bool keeps duplicate-padded points out of the proposals."""
    scores_raw = rpn_cls.reshape(rpn_cls.shape[0], -1)
    scores_norm = torch.sigmoid(scores_raw)
    rois = decode_center(backbone_xyz, rpn_reg, loc_scope, loc_bin_size)
    vote_dist = torch.sqrt(torch.square(rois[..., 0] - backbone_xyz[..., 0])
                           + torch.square(rois[..., 2] - backbone_xyz[..., 2]))
    mask = (scores_norm > score_thresh) & (vote_dist > MIN_VOTE_DIST)
    if point_valid is not None:
        mask &= point_valid
    masked = torch.where(mask, scores_raw, -torch.inf)
    top_scores, top_idx = top_k(masked, pre_nms_top)
    top_valid = torch.isfinite(top_scores)
    centers = _take(rois[..., [0, 2]], top_idx)                    # (B, M, 2)
    d = torch.sqrt(torch.sum(torch.square(
        centers[:, :, None] - centers[:, None]), dim=-1))
    keep = greedy_suppress(-(d - nms_radius), 0.0, top_valid)
    keep_scores = torch.where(keep, top_scores, -torch.inf)
    sel_scores, sel = top_k(keep_scores, max_proposals)
    valid = torch.isfinite(sel_scores)
    centers_k = _take(centers, sel)
    return (torch.where(valid[..., None], centers_k, 0.0),
            torch.where(valid, sel_scores, 0.0), valid)


def z_order_slots(centers, prop_scores, valid):
    """Stable z-order of the proposal slots; invalid slots sort last and
    take the running-max valid centre (the cummax fill)."""
    zkey = torch.where(valid, centers[..., 1], torch.inf)
    order = torch.sort(zkey, dim=1, stable=True).indices
    cx = torch.gather(centers[..., 0], 1, order)
    cz = torch.gather(centers[..., 1], 1, order)
    prop_scores = torch.gather(prop_scores, 1, order)
    valid = torch.gather(valid, 1, order)
    fx = torch.cummax(torch.where(valid, cx, -1e6), dim=1).values
    fz = torch.cummax(torch.where(valid, cz, -1e6), dim=1).values
    centers = torch.stack([torch.where(valid, cx, fx),
                           torch.where(valid, cz, fz)], dim=-1)
    return centers, prop_scores, valid


def bev_first_k_wrap_batched(xyz: torch.Tensor, centers_xz: torch.Tensor,
                             radius: float, num_sampled: int):
    """The first `num_sampled` points within `radius` (BEV) of each centre,
    in point order, `s % cnt` wraparound: xyz (B, N, 3), centers_xz
    (B, K, 2) -> (idx (B, K, S) int32, counts (B, K) int32). One launch of
    kernel 6w on CUDA tensors for the whole batch; as the TPU caller does,
    y is zeroed on both sides, so its 3-D distance is the BEV one."""
    xz = torch.stack([xyz[..., 0], torch.zeros_like(xyz[..., 0]),
                      xyz[..., 2]], dim=-1)
    q = torch.stack([centers_xz[..., 0], torch.zeros_like(centers_xz[..., 0]),
                     centers_xz[..., 1]], dim=-1)
    (idx,), (cnt,) = ball_query_wrap([radius], [num_sampled], xz, q)
    return idx, cnt


def bev_first_k_wrap(xyz: torch.Tensor, centers_xz: torch.Tensor,
                     radius: float, num_sampled: int):
    """Single-scene wrapper of bev_first_k_wrap_batched."""
    idx, cnt = bev_first_k_wrap_batched(xyz[None], centers_xz[None], radius,
                                        num_sampled)
    return idx[0], cnt[0]


def crop_membership(xyz: torch.Tensor, centers_xz: torch.Tensor,
                    max_crop: int, point_valid=None,
                    radius: float = CROP_RADIUS):
    """Whole-crop membership for the proposal database (one scene): the
    first `max_crop` indices of the points within `radius` (BEV) of each
    centre, in point order with `s % cnt` wraparound, and the true in-radius
    count. xyz (N, 3), centers_xz (K, 2) -> idx (K, max_crop) int32,
    count (K,) int32.

    `point_valid` (N,) bool is applied exactly: invalid points move FAR
    off on x and z before the search, so none is within the radius of any
    centre (centres come from valid points), the valid members and their
    indices stay as they were, and the count is that of the valid members,
    as with the JAX package's mask."""
    if point_valid is not None:
        far = torch.full_like(xyz[:, 0], FAR)
        xyz = torch.stack([torch.where(point_valid, xyz[:, 0], far),
                           xyz[:, 1],
                           torch.where(point_valid, xyz[:, 2], far)], dim=-1)
    return bev_first_k_wrap(xyz.contiguous(), centers_xz.contiguous(),
                            radius, max_crop)


def crop_for_rcnn_batched(pts_input: torch.Tensor, scores_norm: torch.Tensor,
                          centers_xz: torch.Tensor, num_sampled: int = 512,
                          sort_z: bool = True, scene_sorted: bool = False):
    """Scene points (B, N, 3+) + centres (B, K, 2) -> stage-2 crops.

    With sort_z each crop comes out ascending by z, as the JAX package's
    crop does: the first 512 members in point order, `s % cnt` slots, then
    a stable sort of each crop by its recentred z. `scene_sorted` promises
    scenes sorted ascending by z (the EVAL loader's): then kernel 5's
    grouped-duplicate order is that order already and no sort runs.
    Without sort_z the crop stays in `s % cnt` order. y is shifted by
    -GROUND_Y after the gather, x/z recentred on the proposal, the mask
    channel is (score > 0.5) - 0.5, empty crops are 0.

    :return: dict(cur_box_point (B, K, S, 3), cur_box_reflect (B, K, S, 1),
        train_mask (B, K, S, 1)), empty (B, K)
    """
    reflect = (pts_input[..., 3] if pts_input.shape[-1] > 3
               else torch.zeros_like(pts_input[..., 0]))
    ch = torch.stack([pts_input[..., 0], pts_input[..., 1], pts_input[..., 2],
                      reflect, scores_norm], dim=1).contiguous()  # (B, 5, N)
    grouped = sort_z and scene_sorted
    (gx, gy, gz, grf, gsn), cnt = crop_gather(
        pts_input[..., 0:3].contiguous(), ch, centers_xz.contiguous(),
        CROP_RADIUS, num_sampled, grouped=grouped)
    empty = cnt == 0
    crop_xyz = torch.stack([gx - centers_xz[..., 0:1], gy - GROUND_Y,
                            gz - centers_xz[..., 1:2]], dim=-1)
    crop_reflect = grf[..., None]
    crop_mask = (gsn > 0.5).to(crop_xyz.dtype)[..., None] - 0.5
    if sort_z and not grouped:
        # a permutation of each crop on the device, stable like lax.sort
        order = torch.sort(crop_xyz[..., 2], dim=-1, stable=True).indices
        crop_xyz = torch.gather(crop_xyz, 2,
                                order[..., None].expand(-1, -1, -1, 3))
        crop_reflect = torch.gather(crop_reflect, 2, order[..., None])
        crop_mask = torch.gather(crop_mask, 2, order[..., None])
    zero = empty[:, :, None, None]
    crops = {"cur_box_point": torch.where(zero, 0.0, crop_xyz),
             "cur_box_reflect": torch.where(zero, 0.0, crop_reflect),
             "train_mask": torch.where(zero, 0.0, crop_mask)}
    return crops, empty


@span("inference.finalize")
def finalize_detections(boxes, rcnn_cls, rcnn_iou, centers_xz, valid,
                        rcnn_thresh: float = 0.3, iou_thresh: float = 0.3,
                        size_gate: bool = True):
    """Batched: boxes (B, K, 7) crop frame bottom-y -> (boxes (B, K, 7)
    scene frame, scores (B, K) = predicted IoU, keep (B, K) bool)."""
    ry = torch.remainder(boxes[..., 6], 2 * math.pi)
    ry = torch.where(ry > math.pi, ry - 2 * math.pi, ry)
    out = torch.stack([boxes[..., 0] + centers_xz[..., 0],
                       boxes[..., 1] + GROUND_Y,
                       boxes[..., 2] + centers_xz[..., 1],
                       boxes[..., 3], boxes[..., 4], boxes[..., 5], ry],
                      dim=-1)
    norm_cls = torch.sigmoid(rcnn_cls)
    iou_score = rcnn_iou
    keep = valid & (norm_cls > rcnn_thresh) & (iou_score > iou_thresh)
    if size_gate:
        h, w, l = out[..., 3], out[..., 4], out[..., 5]
        keep &= ((h > SIZE_GATE[0][0]) & (h < SIZE_GATE[0][1])
                 & (w > SIZE_GATE[1][0]) & (w < SIZE_GATE[1][1])
                 & (l > SIZE_GATE[2][0]) & (l < SIZE_GATE[2][1]))
    order = torch.argsort(-torch.where(keep, iou_score, -torch.inf), dim=-1,
                          stable=True)
    sorted_boxes = _take(out, order)
    iou2d, _ = boxes_iou3d(sorted_boxes, sorted_boxes)
    keep_sorted = greedy_suppress(iou2d - SELF_NMS_IOU, 0.0,
                                  torch.gather(keep, 1, order))
    inv = torch.argsort(order, dim=-1)
    return out, iou_score, torch.gather(keep_sorted, 1, inv)


def _round8(n: int) -> int:
    return max(8, (int(n) + 7) // 8 * 8)


def make_two_stage_fn(model, cfg, num_points: int = 512,
                      pre_nms_top: int = 512,
                      max_proposals: int | None = None, group=None):
    """fn(pts_input (B, N, 3+C)) -> dict(boxes (B, K, 7), scores (B, K),
    keep (B, K), packed (B, K, 9), centers (B, K, 2), proposal_valid (B, K),
    spilled (), n_live ()) on the model's device.

    Stage-2 compaction (cfg.TPU.*_BUDGET_PER_SCENE) pools the live slots of
    the batch; slots beyond a budget are dropped lowest score first and
    counted in `spilled`.

    With a group (parallel.Group) fn takes the rank's contiguous slice of
    the global batch (parallel.data_parallel_infer gives it) and still
    pools over the whole batch, as jit does on a batch-sharded input: every
    rank all-gathers the pool's keys, takes the same top-k of them and runs
    stage 2 on the selected slots of its own scenes. Its boxes are then the
    single batch's, and `spilled` and `n_live` are the whole batch's."""
    K = max_proposals or cfg.TPU.MAX_PROPOSALS
    pre_nms_top = min(pre_nms_top, int(cfg.RPN.NUM_POINTS))
    loc_scope, loc_bin_size = cfg.RPN.LOC_SCOPE, cfg.RPN.LOC_BIN_SIZE
    score_thresh = cfg.RPN.SCORE_THRESH
    rcnn_thresh = cfg.RCNN.SCORE_THRESH
    ioun_on = bool(cfg.IOUN.ENABLED)
    iou_thresh = cfg.IOUN.SCORE_THRESH if ioun_on else 0.0
    rcnn_budget = int(getattr(cfg.TPU, "RCNN_BUDGET_PER_SCENE", 0))
    ioun_budget = int(getattr(cfg.TPU, "IOUN_BUDGET_PER_SCENE", 0))
    sort_z = bool(cfg.TPU.get("SORT_POINTS_Z", True))
    W = 1 if group is None else group.world_size

    def gather(t: torch.Tensor) -> torch.Tensor:
        """The ranks' `t` concatenated in rank order."""
        return t if group is None else all_gather(t, group)

    def run(forward, crops, keys):
        """forward(crops)'s outputs `keys`; a rank that holds no slot of
        the pool launches nothing."""
        first = next(iter(crops.values()))
        if first.shape[0]:
            out = forward(crops)
            return [out[k] for k in keys]
        return [torch.zeros((0, 7) if "box" in k else (0,),
                            device=first.device) for k in keys]

    @torch.no_grad()
    def fn(pts_input: torch.Tensor):
        B = pts_input.shape[0]
        BK = B * K
        rpn_out = model.rpn_forward({"pts_input": pts_input})
        centers, prop_scores, valid = rpn_propose(
            rpn_out["rpn_cls"], rpn_out["rpn_reg"], rpn_out["backbone_xyz"],
            loc_scope, loc_bin_size, score_thresh=score_thresh,
            pre_nms_top=pre_nms_top, max_proposals=K)
        if sort_z:
            centers, prop_scores, valid = z_order_slots(centers, prop_scores,
                                                        valid)
        scores_norm = torch.sigmoid(rpn_out["rpn_cls"][..., 0])
        # the EVAL loader sorts each scene by z (its callers' input)
        crops, empty = crop_for_rcnn_batched(pts_input, scores_norm, centers,
                                             num_sampled=num_points,
                                             sort_z=sort_z, scene_sorted=True)
        live = valid & ~empty
        flat = {k: v.reshape((BK,) + v.shape[2:]) for k, v in crops.items()}
        live_f = live.reshape(BK)
        live_g = gather(live_f)
        spilled = torch.zeros((), dtype=torch.int64, device=pts_input.device)
        lo = 0 if group is None else group.rank * BK   # our first slot

        # the pool: V slots of the whole batch in pool order; `rows` are
        # our slots among them and `pos` their places in it
        V = min(_round8(W * B * rcnn_budget), W * BK) if rcnn_budget > 0 \
            else W * BK
        rows = None
        if V < W * BK:
            with span("inference.compact"):
                key1 = torch.where(live_f, prop_scores.reshape(BK),
                                   -torch.inf)
                _, sel1 = top_k(gather(key1), V)
                spilled = spilled + live_g.sum() - live_g[sel1].sum()
                local = sel1 - lo
                mine = (local >= 0) & (local < BK)
                rows, pos = local[mine], mine.nonzero()[:, 0]
                live_t = live_f[rows]
                crops_t = {k: v[rows] for k, v in flat.items()}
        else:
            pos = torch.arange(lo, lo + BK, device=pts_input.device)
            live_t, crops_t = live_f, flat

        cls_t, boxes_t = run(model.rcnn_trunk_forward, crops_t,
                             ("rcnn_cls", "pred_boxes3d"))
        n_t = cls_t.shape[0]
        if ioun_on:
            V2 = min(_round8(W * B * ioun_budget), V) if ioun_budget > 0 \
                else V
            if V2 < V:
                # the host waits here for the trunk: the boolean index of
                # sel2 reads its length back
                with span("inference.compact"):
                    gate = live_t & (torch.sigmoid(cls_t) > rcnn_thresh)
                    key2 = torch.where(gate, cls_t, -torch.inf)
                    if group is not None:   # the pool's keys, in pool order
                        ours = torch.full((2, V), -torch.inf,
                                          device=key2.device)
                        ours[0, pos] = key2.float()
                        ours[1, pos] = gate.float()
                        key2, gate = gather(ours).reshape(W, 2, V).amax(0)
                        gate = gate > 0
                    _, sel2 = top_k(key2, V2)
                    spilled = spilled + gate.sum() - gate[sel2].sum()
                    row_at = torch.full((V,), -1, dtype=torch.int64,
                                        device=cls_t.device)
                    row_at[pos] = torch.arange(n_t, device=cls_t.device)
                    sel2 = row_at[sel2]
                    sel2 = sel2[sel2 >= 0]  # our rows among the selected
                    crops_c = {k: v[sel2] for k, v in crops_t.items()}
                    crops_c["pred_boxes3d"] = boxes_t[sel2]
                refined, iou_c = run(model.ioun_forward, crops_c,
                                     ("refined_box", "rcnn_iou"))
                # non-cascaded slots keep the trunk box with iou = -inf
                boxes_t = boxes_t.clone()
                boxes_t[sel2] = refined.to(boxes_t.dtype)
                iou_t = torch.full((n_t,), -torch.inf, device=cls_t.device)
                iou_t[sel2] = iou_c.to(iou_t.dtype)
            else:
                boxes_t, iou_t = run(model.ioun_forward,
                                     dict(crops_t, pred_boxes3d=boxes_t),
                                     ("refined_box", "rcnn_iou"))
        else:
            iou_t = torch.sigmoid(cls_t)

        if rows is not None:
            boxes_f = torch.zeros((BK, 7), device=boxes_t.device)
            boxes_f[rows] = boxes_t
            cls_f = torch.full((BK,), -torch.inf, device=cls_t.device)
            cls_f[rows] = cls_t
            iou_f = torch.full((BK,), -torch.inf, device=cls_t.device)
            iou_f[rows] = iou_t
        else:
            boxes_f, cls_f, iou_f = boxes_t, cls_t, iou_t

        boxes, scores, keep = finalize_detections(
            boxes_f.reshape(B, K, 7), cls_f.reshape(B, K),
            iou_f.reshape(B, K), centers, live, rcnn_thresh=rcnn_thresh,
            iou_thresh=iou_thresh)
        packed = torch.cat([boxes, scores[..., None],
                            keep[..., None].to(boxes.dtype)], dim=-1)
        return {"boxes": boxes, "scores": scores, "keep": keep,
                "packed": packed, "centers": centers,
                "proposal_valid": valid, "spilled": spilled,
                "n_live": live_g.sum()}

    return fn
