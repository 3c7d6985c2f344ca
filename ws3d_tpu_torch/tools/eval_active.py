"""Click-seeded annotator eval on the port (the flow of tools/eval_active.py):
the stage-2 net alone, seeded by the weak BEV clicks instead of the RPN.

    python -m ws3d_tpu_torch.tools.eval_active --synthetic --scenes 2 \\
        --bench_weights --cpu

Each Car/Van click of a scene's noise labels expands into a 5 x 5 grid of
0.1 m offsets (25 hypotheses); a scene's hypotheses are padded to a slot
bucket (SLOT_BUCKETS) and its points, after the --max_points subsample, to
a power of two with sentinel points far outside every crop. Scenes of one
(points, slots) bucket run --batch at a time: the 4 m crops of every
hypothesis (kernel 5 in its `s % cnt` mode, each crop then sorted by z:
these scenes are not), the live slots pooled into the V bucket, the
stage-2 net (trunk and IOUN cascade) on them, then the score gates and the
self-NMS with no car-size gate (the reference gates on scores only).
Each batch's packed record is copied to the host once; each scene's kept
boxes go to OUTPUT_DIR/final_result/data/%06d.txt (an empty file for a
scene without a click), then the recall tally and the official KITTI AP.

Weights: --ckpt (the rcnn entries of a port train state or an npz), then
--bench_weights (the fitted ws3d_tpu/data/bench_weights.npz, all of them);
with none the model keeps its seeded init. Runs on CUDA unless --cpu (or
--device cpu). --set TPU.COMPUTE_DTYPE=bfloat16 runs the bf16 compute
dtype.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ws3d_tpu_torch.datasets.kitti_io import objs_to_boxes3d, save_kitti_format
from ws3d_tpu_torch.datasets.rpn_dataset import gaussian_weak_labels
from ws3d_tpu_torch.eval import annos_from_objects, get_official_eval_result
from ws3d_tpu_torch.eval.kitti_ap import anno_from_lines
from ws3d_tpu_torch.eval.recall import RecallTally
from ws3d_tpu_torch.pipeline.inference import (crop_for_rcnn_batched,
                                               finalize_detections, top_k)
from ws3d_tpu_torch.tools.eval_auto import BENCH_WEIGHTS
from ws3d_tpu_torch.tools.train_rpn import (base_parser, close_log,
                                            make_scene_source, setup)

GRID = 5
GRID_STEP = 0.1
SLOT_BUCKETS = (128, 256, 512, 1024)
V_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
SENTINEL = 1e4


def click_gaussian_mask(pts_rect: np.ndarray, centers: np.ndarray,
                        gauss_height: float, gauss_status: float,
                        gauss_cov: float) -> np.ndarray:
    """The Gaussian point mask around the clicks: per point
    exp(-clip(min_k d_k - status, 0, 100)^2 / (2 cov)), the RPN's Gaussian
    weak labels."""
    cls_label, _ = gaussian_weak_labels(
        pts_rect, centers, gauss_height=gauss_height,
        gauss_status=gauss_status, gauss_cov=gauss_cov)
    return cls_label


def expand_clicks(centers_xz: np.ndarray):
    """(M, 2) clicks -> (slots, 2) 5 x 5-grid hypotheses and their valid
    mask, padded to the smallest slot bucket that holds them all."""
    offs = (np.arange(GRID) - GRID // 2) * GRID_STEP
    grid = np.stack(np.meshgrid(offs, offs), -1).reshape(-1, 2)   # (25, 2)
    hyp = (centers_xz[:, None, :] + grid[None]).reshape(-1, 2)
    n = hyp.shape[0]
    slots = next((b for b in SLOT_BUCKETS if b >= n), None)
    if slots is None:
        raise ValueError(
            f"{n} hypotheses ({centers_xz.shape[0]} clicks) exceed the "
            f"largest jit bucket {SLOT_BUCKETS[-1]}; split the scene")
    valid = np.zeros(slots, bool)
    valid[:n] = True
    pad = np.zeros((slots - n, 2), np.float32)
    return (np.concatenate([hyp, pad]).astype(np.float32), valid)


def plan_batches(bucket_keys, batch_size):
    """Scene indices grouped by bucket key into batches of `batch_size`:
    [(key, [scene indices], n_pad_scenes)]; a short batch repeats its
    first index (those entries run with no valid slot and are dropped)."""
    groups: dict = {}
    for i, key in enumerate(bucket_keys):
        groups.setdefault(key, []).append(i)
    plan = []
    for key, idxs in groups.items():
        for off in range(0, len(idxs), batch_size):
            chunk = idxs[off:off + batch_size]
            n_pad = batch_size - len(chunk)
            plan.append((key, chunk + [chunk[0]] * n_pad, n_pad))
    return plan


def pick_v_bucket(n_live: int, max_v: int) -> int:
    """The smallest V bucket that holds every live slot (no hypothesis is
    ever dropped), else max_v."""
    for b in V_BUCKETS:
        if b >= n_live and b <= max_v:
            return b
    return max_v


def scene_entry(scene, cfg, max_points: int, seed: int):
    """The host pass of one scene: the --max_points subsample (a pure
    function of the seed and the sample id, index-sorted), the points
    padded to a power of two with sentinels, the Car/Van clicks' hypotheses
    and the click mask -> (pts (n_pad, 4), scores (n_pad,), hyp (slots, 2),
    valid (slots,)), or None for a scene without a click."""
    clicks = objs_to_boxes3d(
        [o for o in scene.noise_labels if o.cls_type in ("Car", "Van")])
    pts_rect, intensity = scene.pts_rect, scene.pts_intensity
    if max_points and pts_rect.shape[0] > max_points:
        rs = np.random.RandomState(
            (seed * 100003 + 7919 * int(scene.sample_id) + 1) % (2**31 - 1))
        sel = np.sort(rs.choice(pts_rect.shape[0], max_points,
                                replace=False))
        pts_rect, intensity = pts_rect[sel], intensity[sel]
    if clicks.shape[0] == 0:
        return None
    pts = np.hstack([pts_rect, intensity[:, None] - 0.5])
    n_pad = 1 << max(int(np.ceil(np.log2(max(pts.shape[0], 1024)))), 10)
    if pts.shape[0] < n_pad:
        pts = np.concatenate([pts, np.full(
            (n_pad - pts.shape[0], pts.shape[1]), SENTINEL, np.float32)])
    hyp, valid = expand_clicks(clicks[:, [0, 2]])
    scores = np.zeros(pts.shape[0], np.float32)
    scores[:pts_rect.shape[0]] = click_gaussian_mask(
        pts_rect, clicks[:, 0:3], cfg.RPN.GAUSS_HEIGHT, cfg.RPN.GAUSS_STATUS,
        cfg.RPN.GAUSS_COV)
    return pts.astype(np.float32), scores, hyp, valid


@torch.no_grad()
def infer_batch(model, cfg, pts, scores, centers, valid, V: int):
    """pts (B, N, 4), scores (B, N), centers (B, K, 2), valid (B, K) on the
    model's device -> (packed (B, K, 9): scene-frame box, score, keep;
    live (B, K)). The live slots of the batch come first in slot order
    among the V that run the stage-2 net; a slot that did not run has
    scores -inf."""
    B, K = centers.shape[0], centers.shape[1]
    crops, empty = crop_for_rcnn_batched(pts, scores, centers,
                                         scene_sorted=False)
    live = valid & ~empty
    flat = {k: v.reshape((B * K,) + v.shape[2:]) for k, v in crops.items()}
    sel = None
    if V < B * K:
        _, sel = top_k(live.reshape(B * K).float(), V)
        flat = {k: v[sel] for k, v in flat.items()}
    out = model.rcnn_forward(flat)
    boxes_c = out.get("refined_box", out["pred_boxes3d"]).reshape(-1, 7)
    cls_c = out["rcnn_cls"].reshape(-1)
    iou_c = out.get("rcnn_iou", torch.sigmoid(out["rcnn_cls"])).reshape(-1)
    if sel is not None:
        boxes_f = boxes_c.new_zeros((B * K, 7))
        boxes_f[sel] = boxes_c
        cls_f = torch.full((B * K,), -torch.inf, device=cls_c.device)
        cls_f[sel] = cls_c.float()
        iou_f = torch.full((B * K,), -torch.inf, device=cls_c.device)
        iou_f[sel] = iou_c.float()
    else:
        boxes_f, cls_f, iou_f = boxes_c, cls_c, iou_c
    boxes, sc, keep = finalize_detections(
        boxes_f.reshape(B, K, 7), cls_f.reshape(B, K), iou_f.reshape(B, K),
        centers, live, rcnn_thresh=cfg.RCNN.SCORE_THRESH,
        iou_thresh=cfg.IOUN.SCORE_THRESH, size_gate=False)
    packed = torch.cat([boxes, sc[..., None], keep[..., None].to(boxes.dtype)],
                       dim=-1)
    return packed, live


def run_active(model, cfg, src, log, *, scenes, batch=8, max_points=16384,
               seed=0, output_dir, no_ap=False, stats=None):
    """The click-seeded eval on the model's device: host pass, batched
    device pass, KITTI txt files, recall tally and the official AP. Returns
    the AP dict (None with no_ap). Where `stats` is a dict it receives the
    scene count, the scenes with clicks, the detections, the recall lines,
    per batch (hypotheses, live slots, V), and the seconds of the host
    pass, the device pass (batches and their host copies) and the host's
    txt files and tally."""
    device = next(model.parameters()).device
    t0 = time.perf_counter()
    loaded, entries = [], []
    for i in range(scenes):
        scene = src.get_scene(src.sample_ids[i], with_noise=True)
        loaded.append(scene)
        entries.append(scene_entry(scene, cfg, max_points, seed))
    t_load = time.perf_counter() - t0

    out_dir = os.path.join(output_dir, "final_result", "data")
    live_idx = [i for i in range(scenes) if entries[i] is not None]
    plan = plan_batches([(entries[i][0].shape[0], entries[i][3].shape[0])
                         for i in live_idx], batch)
    t0 = time.perf_counter()
    drained, batches = [], []
    for _, rel_idxs, n_pad_scenes in plan:
        idxs = [live_idx[r] for r in rel_idxs]

        def stack(j):
            return torch.from_numpy(np.stack([entries[i][j] for i in idxs]))
        valid = np.stack([entries[i][3] for i in idxs])
        if n_pad_scenes:
            valid[len(idxs) - n_pad_scenes:] = False
        V = pick_v_bucket(int(valid.sum()), valid.size)
        packed, live = infer_batch(
            model, cfg, stack(0).to(device), stack(1).to(device),
            stack(2).to(device), torch.from_numpy(valid).to(device), V)
        drained.append((idxs[:batch - n_pad_scenes], packed.cpu().numpy()))
        batches.append((int(valid.sum()), live, V))
    t_dev = time.perf_counter() - t0

    t0 = time.perf_counter()
    tally = RecallTally()
    n_boxes = 0
    for idxs, packed in drained:
        for j, i in enumerate(idxs):
            keep = packed[j, :, 8] > 0.5
            boxes, sc = packed[j, :, 0:7][keep], packed[j, :, 7][keep]
            n_boxes += boxes.shape[0]
            save_kitti_format(loaded[i].sample_id, loaded[i].calib, boxes,
                              out_dir, sc, loaded[i].image_shape,
                              classes=cfg.CLASSES)
            tally.update(boxes, objs_to_boxes3d(
                [o for o in loaded[i].labels
                 if o.cls_type in ("Car", "Van")]))
    t_host = time.perf_counter() - t0
    dt = t_dev + t_host
    log.info("%d scenes (%d with clicks) in %.2fs = %.1f scenes/sec "
             "(device+transfer %.2fs = %.1f scenes/sec; host dump/tally "
             "%.2fs), %d batches, %d boxes", scenes, len(live_idx), dt,
             scenes / dt, t_dev, scenes / max(t_dev, 1e-9), t_host,
             len(plan), n_boxes)

    gt_frames, dt_paths = [], []
    for i, scene in enumerate(loaded):
        if entries[i] is None:
            save_kitti_format(scene.sample_id, scene.calib, np.zeros((0, 7)),
                              out_dir, np.zeros(0), scene.image_shape,
                              classes=cfg.CLASSES)
        gt_frames.append(scene.labels)
        dt_paths.append(os.path.join(out_dir, "%06d.txt" % scene.sample_id))
    for line in tally.summary_lines():
        log.info(line)
    if stats is not None:
        stats.update(
            scenes=scenes, with_clicks=len(live_idx), detections=n_boxes,
            recall=tally.summary_lines(),
            batches=[(h, int(live.sum()), V) for h, live, V in batches],
            seconds={"load": t_load, "device": t_dev, "host": t_host})
    if no_ap:
        return None
    dt_annos = []
    for path in dt_paths:
        with open(path) as f:
            dt_annos.append(anno_from_lines(f.readlines()))
    result, ret = get_official_eval_result(annos_from_objects(gt_frames),
                                           dt_annos, cfg.CLASSES)
    log.info("\n%s", result)
    if stats is not None:
        stats["result"] = result
    return ret


def main(argv=None) -> int:
    p = base_parser("click-seeded annotator eval (stage-2 only)")
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--batch", type=int, default=8,
                   help="scenes per device batch")
    p.add_argument("--max_points", type=int, default=16384,
                   help="per-scene point cap, a pure function of (seed, "
                        "sample id); 0 = no cap")
    p.add_argument("--no_ap", action="store_true")
    p.add_argument("--bench_weights", action="store_true",
                   help="load ws3d_tpu/data/bench_weights.npz (the fitted "
                        "weights) last")
    args = p.parse_args(argv)
    cfg, log = setup(args, "eval_active")
    try:
        cfg.RCNN.ENABLED = True
        cfg.IOUN.ENABLED = True
        from ws3d_tpu_torch.models import build_model
        from ws3d_tpu_torch.training import load_part_checkpoint
        from ws3d_tpu_torch.weights import load_npz

        src = make_scene_source(args, num_scenes=args.scenes)
        model = build_model(cfg, device="cpu" if args.cpu else args.device,
                            seed=args.seed)
        if args.ckpt:
            n = load_part_checkpoint(model, args.ckpt, subtrees=("rcnn",))
            log.info("loaded %d tensors from ckpt %s", n, args.ckpt)
        if args.bench_weights:
            n = load_npz(model, BENCH_WEIGHTS)
            log.info("loaded the fitted bench weights (%d tensors)", n)
        log.info("device: %s", next(model.parameters()).device)
        run_active(model, cfg, src, log, scenes=args.scenes,
                   batch=args.batch, max_points=args.max_points,
                   seed=args.seed, output_dir=args.output_dir,
                   no_ap=args.no_ap)
        return 0
    finally:
        close_log(log)


if __name__ == "__main__":
    sys.exit(main())
