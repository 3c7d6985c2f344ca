"""Stage-1 (weak RPN) training on the port (the flow of tools/train_rpn.py).

    python -m ws3d_tpu_torch.tools.train_rpn --synthetic --steps 2 \\
        --batch 2 --points 2048 --device cpu

Trains the centre-vote RPN on Gaussian labels around the weak BEV clicks
with OneCycle Adam, gradient clip 1.0 and the BN-momentum decay, writes
resume checkpoints every --ckpt_every steps, re-estimates the BatchNorm
statistics at the final weights and saves OUTPUT_DIR/rpn_ckpt.pt (the train
state) and OUTPUT_DIR/rpn_weights.npz (the JAX package's flat keys). Runs on
CUDA unless --device cpu. In-training validation, TensorBoard output, the
data-parallel mesh and the GT-database augmentation are not ported; scenes
come from the synthetic generator.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--cfg_file", type=str, default=None,
                   help="optional YAML config overriding the defaults")
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=None,
                   help="key=value config overrides")
    p.add_argument("--data_root", type=str, default=None,
                   help="KITTI root dir (not ported: use --synthetic)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the synthetic scene generator (no KITTI)")
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--ckpt", type=str, default=None,
                   help="checkpoint to start from (see the tool's "
                        "docstring)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the current CUDA device; "
                        "'cpu' runs the plain PyTorch versions)")
    p.add_argument("--cpu", action="store_true", help="same as --device cpu")
    return p


def setup(args, name: str = "train_rpn"):
    from ws3d_tpu_torch.config import load_config
    cfg = load_config(args.cfg_file, args.set_cfgs)
    os.makedirs(args.output_dir, exist_ok=True)
    log = logging.getLogger(f"ws3d_tpu_torch.{name}")
    log.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)5s %(message)s")
    for h in (logging.StreamHandler(),
              logging.FileHandler(os.path.join(args.output_dir, "log.txt"))):
        h.setFormatter(fmt)
        log.addHandler(h)
    return cfg, log


def close_log(log: logging.Logger) -> None:
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()


def make_scene_source(args, num_scenes: int = 64, points: int = 18000):
    if args.data_root and not args.synthetic:
        raise SystemExit("KITTI loading is not ported yet; run with "
                         "--synthetic")
    from ws3d_tpu_torch.datasets import SyntheticKitti
    return SyntheticKitti(num_scenes=num_scenes, points_per_scene=points,
                          seed=args.seed)


def main(argv=None) -> int:
    p = base_parser("train stage-1 RPN from weak BEV-click labels")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=8000)
    p.add_argument("--points", type=int, default=None)
    p.add_argument("--weakly_num", type=int, default=500,
                   help="weak-scene budget (first N non-empty scenes)")
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--scenes", type=int, default=64,
                   help="synthetic scene count")
    args = p.parse_args(argv)
    cfg, log = setup(args)
    try:
        return train(args, cfg, log)
    finally:
        close_log(log)


def train(args, cfg, log) -> int:
    if args.points:
        cfg.RPN.NUM_POINTS = args.points
        if args.points <= 2048:
            cfg.RPN.SA_CONFIG.NPOINTS = [args.points // 4, args.points // 16,
                                         args.points // 64, args.points // 256]

    from ws3d_tpu_torch.datasets import RPNDataset
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training import (Trainer, restore_train_state,
                                         save_train_state)
    from ws3d_tpu_torch.weights import save_npz

    src = make_scene_source(args, num_scenes=args.scenes)
    ds = RPNDataset(src, cfg, mode="TRAIN",
                    weakly_num=args.weakly_num if not args.synthetic else None,
                    seed=args.seed)
    log.info("dataset: %d scenes, %d points/scene", len(ds),
             cfg.RPN.NUM_POINTS)

    model = build_model(cfg, device="cpu" if args.cpu else args.device,
                        seed=args.seed)
    trainer = Trainer(model, cfg, total_steps=args.steps, stage="rpn",
                      seed=args.seed, log_fn=log.info)
    log.info("device: %s", trainer.device)
    epoch_size = max(len(ds) // args.batch, 1)
    if args.ckpt:
        step = restore_train_state(args.ckpt, model, trainer.optimizer)
        log.info("resumed from %s at step %d", args.ckpt, step)

    trainer.train_steps(ds.batches(args.batch, shuffle=True),
                        total_steps=args.steps,
                        log_every=max(args.steps // 100, 1),
                        epoch_size=epoch_size, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.output_dir)
    trainer.recalibrate_bn(ds.batches(args.batch, shuffle=True))

    ckpt = save_train_state(os.path.join(args.output_dir, "rpn_ckpt.pt"),
                            model, trainer.optimizer)
    log.info("saved checkpoint: %s", ckpt)
    npz = os.path.join(args.output_dir, "rpn_weights.npz")
    save_npz(model, npz)
    log.info("saved weights: %s", npz)
    return 0


if __name__ == "__main__":
    sys.exit(main())
