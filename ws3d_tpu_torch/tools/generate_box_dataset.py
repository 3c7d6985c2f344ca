"""Stage-1 -> stage-2 handoff on the port (the flow of
tools/generate_box_dataset.py): build the proposal-crop database that
BoxPlaceDataset and train_cascade --db read.

    python -m ws3d_tpu_torch.tools.generate_box_dataset --synthetic \\
        --scenes 2 --points 4096 --bench_weights --device cpu --out db.pkl

For each scene: every valid point (get_whole_scene, padded or subsampled
to --points), the trained RPN, per-point centre votes through the score
(--score_thresh) and vote-distance gates and radius-0.3 greedy NMS, at most
--max_proposals centres; for each, the points within 4 m BEV (the first
--max_crop, counted in full; kernel 6w on CUDA). That is the device stage,
one scene a call (propose_and_crop). The host loop (scene_records) then
keeps crops of more than 5 points, recentres them in x/z and labels each
against the ground truth: foreground if a real or weak-label centre lies
within 0.7 m; within 1.5 m of a real box, that box (recentred) and a 0/1
mask of the crop points inside it scaled by 1.2. The pickle's records have
the JAX tool's keys and dtypes.

Stage-1 weights: --ckpt (a port train state such as rpn_ckpt.pt, or an
npz of flat weights) and/or --bench_weights (the fitted
ws3d_tpu/data/bench_weights.npz); with neither the RPN keeps its seeded
init. Runs on CUDA unless --device cpu. Scenes come from the synthetic
generator (KITTI loading is not ported).
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch

from ws3d_tpu_torch.tools.train_rpn import (base_parser, close_log,
                                            make_scene_source, setup)

BENCH_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "ws3d_tpu", "data", "bench_weights.npz")
MIN_CROP = 5            # crops of at most this many points are dropped
FG_DIST = 0.7           # a centre within this of a box centre: foreground
GT_DIST = 1.5           # ... within this of a real box: attach that box
GT_MASK_SCALE = 1.2     # box dims scale of the gt point mask


def main(argv=None) -> int:
    p = base_parser("generate the stage-2 proposal database from a "
                    "stage-1 RPN")
    p.add_argument("--out", type=str, default=None,
                   help="pickle path (default OUTPUT_DIR/boxes.pkl)")
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--points", type=int, default=None,
                   help="fixed point budget of the whole-scene cloud "
                        "(default cfg.RPN.NUM_POINTS; scenes are "
                        "duplicate-padded / subsampled to this)")
    p.add_argument("--score_thresh", type=float, default=0.1)
    p.add_argument("--max_proposals", type=int, default=64)
    p.add_argument("--max_crop", type=int, default=2048,
                   help="per-crop point cap (crops past it are truncated "
                        "and counted)")
    p.add_argument("--bench_weights", action="store_true",
                   help="load the stage-1 entries of "
                        "ws3d_tpu/data/bench_weights.npz")
    args = p.parse_args(argv)
    cfg, log = setup(args, "generate_box_dataset")
    try:
        return generate(args, cfg, log)
    finally:
        close_log(log)


def load_rpn(cfg, device=None, weights=(), seed: int = 0):
    """The stage-1 model on `device` with its seeded init, then the rpn
    entries of each checkpoint in `weights` (a train state or an npz), in
    order."""
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training import load_part_checkpoint
    cfg.RCNN.ENABLED = False
    cfg.IOUN.ENABLED = False
    model = build_model(cfg, device=device, seed=seed)
    for path in weights:
        if load_part_checkpoint(model, path, subtrees=("rpn",)) == 0:
            raise RuntimeError(f"{path} holds no rpn entries")
    return model


@torch.no_grad()
def propose_and_crop(model, cfg, pts: torch.Tensor, valid: torch.Tensor,
                     score_thresh: float = 0.1, max_proposals: int = 64,
                     max_crop: int = 2048):
    """The device stage of one scene (the counterpart of the jitted `infer`
    of tools/generate_box_dataset.py): pts (P, 3+C) and valid (P,) bool on
    the model's device -> centers (K, 2), scores_norm (P,) (the sigmoid RPN
    score of every point), proposal_valid (K,), idx (K, max_crop) int32 and
    count (K,) int32 of each proposal's 4 m crop."""
    from ws3d_tpu_torch.pipeline.inference import crop_membership, rpn_propose
    out = model.rpn_forward({"pts_input": pts[None]})
    centers, _, pvalid = rpn_propose(
        out["rpn_cls"], out["rpn_reg"], out["backbone_xyz"],
        cfg.RPN.LOC_SCOPE, cfg.RPN.LOC_BIN_SIZE, score_thresh=score_thresh,
        max_proposals=max_proposals, point_valid=valid[None])
    scores_norm = torch.sigmoid(out["rpn_cls"][0, :, 0])
    idx, count = crop_membership(pts[:, 0:3], centers[0], max_crop,
                                 point_valid=valid)
    return centers[0], scores_norm, pvalid[0], idx, count


def scene_records(sample, centers, scores_norm, pvalid, idx, count,
                  max_crop: int, first_id: int = 0):
    """The host loop of one scene (tools/generate_box_dataset.py:102-167)
    on numpy arrays: -> (records, tally) where tally counts the proposals
    near a weak label (`recall`), the weak labels (`gt`), the truncated
    crops and the fg / bg / G-fg records."""
    from ws3d_tpu_torch.datasets.rpn_dataset import points_in_rotated_boxes_np
    pts = sample["pts_input"]
    gt_boxes, noise_boxes = sample["gt_boxes"], sample["noise_boxes"]
    tally = {"recall": 0, "gt": len(noise_boxes), "truncated": 0, "fg": 0,
             "bg": 0, "gfg": 0}
    if len(noise_boxes) and pvalid.any():
        d_pn = np.hypot(noise_boxes[:, None, 0] - centers[None, pvalid, 0],
                        noise_boxes[:, None, 2] - centers[None, pvalid, 1])
        tally["recall"] = int((d_pn.min(axis=1) < FG_DIST).sum())
    records = []
    for k in range(centers.shape[0]):
        if not pvalid[k]:
            continue
        n_in = int(count[k])
        if n_in > max_crop:
            tally["truncated"] += 1
            n_in = max_crop
        if n_in <= MIN_CROP:
            continue
        sel = idx[k, :n_in]
        center = np.array([centers[k, 0], 0.0, centers[k, 1]], np.float32)
        crop_pts = pts[sel, 0:3] - center[None, :]
        reflect = (pts[sel, 3] if pts.shape[1] > 3
                   else np.zeros(n_in, np.float32))
        fg_flag = False
        box_id = -1
        gt_box = np.zeros(7, np.float32)
        gt_mask = np.zeros(n_in, np.float32)
        d_real = (np.hypot(gt_boxes[:, 0] - center[0],
                           gt_boxes[:, 2] - center[2])
                  if len(gt_boxes) else np.full(1, np.inf))
        d_noise = (np.hypot(noise_boxes[:, 0] - center[0],
                            noise_boxes[:, 2] - center[2])
                   if len(noise_boxes) else np.full(1, np.inf))
        if d_real.min() < FG_DIST or d_noise.min() < FG_DIST:
            fg_flag = True
        if d_real.min() < GT_DIST and len(gt_boxes):
            box_id = int(d_real.argmin())
            gt_box = gt_boxes[box_id].copy()
            gt_box[0] -= center[0]
            gt_box[2] -= center[2]
            big = gt_box.copy()
            big[3:6] *= GT_MASK_SCALE
            gt_mask = points_in_rotated_boxes_np(
                crop_pts, big[None])[:, 0].astype(np.float32)
        records.append({
            "instance_id": first_id + len(records),
            "sample_id": int(sample["sample_id"]),
            "box_id": box_id,
            "center": center,
            "foreground_flag": fg_flag,
            "gt_boxes": gt_box,
            "cur_box_point": crop_pts.astype(np.float32),
            "cur_box_reflect": reflect.astype(np.float32),
            "cur_prob_mask": scores_norm[sel].astype(np.float32),
            "gt_mask": gt_mask,
        })
        tally["fg"] += int(fg_flag)
        tally["gfg"] += int(box_id >= 0)
        tally["bg"] += int(not fg_flag)
    return records, tally


def generate(args, cfg, log) -> int:
    from ws3d_tpu_torch.datasets import RPNDataset
    if args.points:
        cfg.RPN.NUM_POINTS = args.points
        if args.points <= 2048:
            cfg.RPN.SA_CONFIG.NPOINTS = [args.points // 4, args.points // 16,
                                         args.points // 64, args.points // 256]
    src = make_scene_source(args, num_scenes=args.scenes)
    ds = RPNDataset(src, cfg, mode="EVAL", seed=args.seed)
    weights = ([args.ckpt] if args.ckpt else []) + (
        [BENCH_WEIGHTS] if args.bench_weights else [])
    model = load_rpn(cfg, "cpu" if args.cpu else args.device, weights,
                     args.seed)
    device = next(model.parameters()).device
    log.info("device: %s; rpn weights: %s", device,
             ", ".join(weights) or "seeded init")
    num_points = int(cfg.RPN.NUM_POINTS)

    database = []
    total = dict.fromkeys(("recall", "gt", "truncated", "fg", "bg", "gfg"), 0)
    for i in range(min(len(ds), args.scenes)):
        sample = ds.get_whole_scene(i, max_points=num_points)
        out = propose_and_crop(
            model, cfg, torch.from_numpy(sample["pts_input"]).to(device),
            torch.from_numpy(sample["valid"]).to(device),
            score_thresh=args.score_thresh,
            max_proposals=args.max_proposals, max_crop=args.max_crop)
        records, tally = scene_records(sample, *[o.cpu().numpy()
                                                 for o in out],
                                       args.max_crop, len(database))
        database += records
        for k, v in tally.items():
            total[k] += v
        log.info("scene %d (id %d): %d proposals so far — fg %d, bg %d, "
                 "Gfg %d, recall %.4f", i, int(sample["sample_id"]),
                 len(database), total["fg"], total["bg"], total["gfg"],
                 total["recall"] / max(total["gt"], 1))
    if total["truncated"]:
        log.warning("%d crops exceeded --max_crop=%d and were truncated",
                    total["truncated"], args.max_crop)

    out_path = args.out or os.path.join(args.output_dir, "boxes.pkl")
    with open(out_path, "wb") as f:
        pickle.dump(database, f)
    log.info("wrote %d records -> %s", len(database), out_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
