"""Two-stage eval and auto-annotator on the port (the flow of
tools/eval_auto.py): detections -> KITTI txt files -> recall tally ->
the official KITTI AP.

    python -m ws3d_tpu_torch.tools.eval_auto --synthetic --scenes 2 \\
        --points 4096 --bench_weights --cpu

Scenes come from the EVAL loader over the synthetic generator or, with
--data_root, a KITTI tree (KittiRaw). The batched make_two_stage_fn runs
--batch scenes a call; each batch's packed record is copied to the host
once, and each scene's kept boxes are written to
OUTPUT_DIR/final_result/data/%06d.txt. Weights: --ckpt (the rpn and rcnn
entries of a port train state or an npz), --rpn_ckpt (its rpn entries) and
--bench_weights (the fitted ws3d_tpu/data/bench_weights.npz, all of them),
in that order; with none the model keeps its seeded init. Runs on CUDA
unless --cpu (or --device cpu). --set TPU.COMPUTE_DTYPE=bfloat16 runs the
bf16 compute dtype (ws3d_tpu_torch.tools.diff_detections bounds it against
f32). Data-parallel eval (--mesh) is not ported.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ws3d_tpu_torch.datasets.kitti_io import objs_to_boxes3d, save_kitti_format
from ws3d_tpu_torch.eval import annos_from_objects, get_official_eval_result
from ws3d_tpu_torch.eval.kitti_ap import anno_from_lines
from ws3d_tpu_torch.eval.recall import RecallTally
from ws3d_tpu_torch.pipeline import make_two_stage_fn
from ws3d_tpu_torch.tools.train_rpn import (base_parser, close_log,
                                            make_scene_source, setup)

BENCH_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "ws3d_tpu", "data", "bench_weights.npz")


def main(argv=None) -> int:
    p = base_parser("two-stage eval / auto-annotator with KITTI AP")
    p.add_argument("--scenes", type=int, default=16)
    p.add_argument("--points", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--no_ap", action="store_true")
    p.add_argument("--rpn_ckpt", type=str, default=None,
                   help="a stage-1 checkpoint whose rpn entries are loaded "
                        "after --ckpt")
    p.add_argument("--bench_weights", action="store_true",
                   help="load ws3d_tpu/data/bench_weights.npz (the fitted "
                        "weights) last")
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel eval over N devices (not ported)")
    args = p.parse_args(argv)
    if args.mesh:
        raise SystemExit("--mesh: data-parallel eval is not ported yet "
                         "(ROADMAP.md queue 1, item 7, scale-out)")
    cfg, log = setup(args, "eval_auto")
    try:
        configure(cfg, args.points)
        from ws3d_tpu_torch.datasets import RPNDataset
        from ws3d_tpu_torch.models import build_model
        from ws3d_tpu_torch.training import load_part_checkpoint
        from ws3d_tpu_torch.weights import load_npz

        src = make_scene_source(args, num_scenes=args.scenes)
        ds = RPNDataset(src, cfg, mode="EVAL", seed=args.seed)
        model = build_model(cfg, device="cpu" if args.cpu else args.device,
                            seed=args.seed)
        if args.ckpt:
            n = load_part_checkpoint(model, args.ckpt,
                                     subtrees=("rpn", "rcnn"))
            log.info("loaded %d tensors from ckpt %s", n, args.ckpt)
        if args.rpn_ckpt:
            n = load_part_checkpoint(model, args.rpn_ckpt, subtrees=("rpn",))
            log.info("loaded %d rpn tensors from %s", n, args.rpn_ckpt)
        if args.bench_weights:
            n = load_npz(model, BENCH_WEIGHTS)
            log.info("loaded the fitted bench weights (%d tensors)", n)
        log.info("device: %s", next(model.parameters()).device)
        run_eval(model, cfg, src, ds, log, scenes=args.scenes,
                 batch=args.batch, output_dir=args.output_dir,
                 no_ap=args.no_ap)
        return 0
    finally:
        close_log(log)


def configure(cfg, points=None) -> None:
    """The two-stage eval's config: RCNN and IOUN on; `points` sets the
    scene's points, with the SA NPOINTS scaled down at 2,048 and below."""
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    if points:
        cfg.RPN.NUM_POINTS = points
        if points <= 2048:
            cfg.RPN.SA_CONFIG.NPOINTS = [points // 4, points // 16,
                                         points // 64, points // 256]


def run_eval(model, cfg, src, ds, log, *, scenes, batch=1, output_dir,
             no_ap=False, fn=None, stats=None):
    """The batched two-stage eval loop on the model's device: detections ->
    KITTI txt files -> recall tally -> official AP. Returns the AP result
    dict (None with no_ap). `fn` may be a two-stage function made before
    (make_two_stage_fn(model, cfg) by default). Where `stats` is a dict it
    receives the detection count, the scene count, the recall lines, the
    seconds spent in inference (the batches and their host copies), in
    writing the txt files and in the AP harness, and the (gt, dt) annos
    the AP was taken over."""
    device = next(model.parameters()).device
    if fn is None:
        fn = make_two_stage_fn(model, cfg)
    out_dir = os.path.join(output_dir, "final_result", "data")
    tally = RecallTally()
    gt_frames, sample_ids, det_count = [], [], 0
    seconds = {"inference": 0.0, "txt": 0.0, "ap": 0.0}
    n = min(len(ds), scenes)
    bsz = max(batch, 1)
    for lo in range(0, n, bsz):
        idxs = list(range(lo, min(lo + bsz, n)))
        samples = [ds.get_sample(i) for i in idxs]
        stack = np.stack([s["pts_input"] for s in samples])
        if stack.shape[0] < bsz:     # pad the tail batch to the batch shape
            stack = np.concatenate(
                [stack, np.repeat(stack[-1:], bsz - stack.shape[0], 0)])
        t0 = time.perf_counter()
        packed = fn(torch.from_numpy(stack).to(device))["packed"].cpu(
            ).numpy()                 # one host copy a batch
        seconds["inference"] += time.perf_counter() - t0
        for j, i in enumerate(idxs):
            scene = src.get_scene(ds.sample_ids[i])
            keep = packed[j, :, 8] > 0.5
            boxes = packed[j, :, 0:7][keep]
            scores = packed[j, :, 7][keep]
            det_count += boxes.shape[0]
            sample_ids.append(int(samples[j]["sample_id"]))
            t0 = time.perf_counter()
            save_kitti_format(sample_ids[-1], scene.calib,
                              boxes, out_dir, scores, scene.image_shape,
                              classes=cfg.CLASSES)
            seconds["txt"] += time.perf_counter() - t0
            gt_frames.append(scene.labels)
            gt_boxes = objs_to_boxes3d(
                [o for o in scene.labels if o.cls_type in ("Car", "Van")])
            tally.update(boxes, gt_boxes)
            log.info("scene %d: %d detections (recall %d/%d)", i,
                     boxes.shape[0], tally.recalled[3], tally.total_gt)

    log.info("total detections: %d over %d scenes", det_count, n)
    for line in tally.summary_lines():
        log.info(line)
    if stats is not None:
        stats.update(detections=det_count, scenes=n,
                     recall=tally.summary_lines(), seconds=seconds)
    if no_ap:
        return None
    t0 = time.perf_counter()
    gt_annos = annos_from_objects(gt_frames)
    dt_annos = []
    for sid in sample_ids:
        with open(os.path.join(out_dir, "%06d.txt" % sid)) as f:
            dt_annos.append(anno_from_lines(f.readlines()))
    result, ret = get_official_eval_result(gt_annos, dt_annos, cfg.CLASSES)
    seconds["ap"] = time.perf_counter() - t0
    log.info("\n%s", result)
    log.info("Car 3D AP e/m/h: %.2f / %.2f / %.2f",
             ret["Car_3d_easy"], ret["Car_3d_moderate"],
             ret["Car_3d_hard"])
    log.info("seconds: inference %.3f, txt files %.3f, AP harness %.3f",
             seconds["inference"], seconds["txt"], seconds["ap"])
    if stats is not None:
        stats["annos"] = (gt_annos, dt_annos)
    return ret


if __name__ == "__main__":
    sys.exit(main())
