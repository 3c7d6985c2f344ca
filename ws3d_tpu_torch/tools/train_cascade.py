"""Stage-2 training on the port (the flow of tools/train_cascade.py): the
RCNN head (--stage rcnn, alias cascade1) or the IOUN cascade on a frozen
RCNN trunk (--stage ioun, alias cascade_later).

    python -m ws3d_tpu_torch.tools.train_cascade --stage rcnn --synthetic \\
        --steps 2 --batch 8 --npoints 128 --device cpu --output_dir out
    python -m ws3d_tpu_torch.tools.train_cascade --stage ioun --synthetic \\
        --steps 2 --batch 8 --npoints 128 --device cpu \\
        --ckpt out/rcnn_ckpt.pt --output_dir out_ioun

Crops come from a proposal database (--db, the pickle of
tools/generate_box_dataset.py) or from synthetic_proposal_database
(--synthetic), through BoxPlaceDataset's TRAIN augmentation and the
prob_mask_ratio schedule. --ckpt warms the model's rcnn entries from a
checkpoint (a train state or an npz); the cascade of an IOUN model stays
fresh where it lacks them. Writes OUTPUT_DIR/<stage>_ckpt.pt (the train
state) and OUTPUT_DIR/<stage>_weights.npz (the JAX package's flat keys).
Runs on CUDA unless --device cpu. In-training validation and TensorBoard
output are not ported.
"""
from __future__ import annotations

import os
import pickle
import sys

from ws3d_tpu_torch.tools.train_rpn import base_parser, close_log, setup

STAGE_ALIASES = {"rcnn": "rcnn", "cascade1": "rcnn", "ioun": "ioun",
                 "cascade_later": "ioun"}


def main(argv=None) -> int:
    p = base_parser("train the stage-2 RCNN / IOUN cascade")
    p.add_argument("--stage", choices=sorted(STAGE_ALIASES), default="rcnn")
    p.add_argument("--db", type=str, default=None,
                   help="proposal database pickle from generate_box_dataset")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=40000)
    p.add_argument("--npoints", type=int, default=512)
    p.add_argument("--cascade", type=int, default=None)
    p.add_argument("--weakly_ratio", type=float, default=None)
    p.add_argument("--db_size", type=int, default=64,
                   help="synthetic database size")
    args = p.parse_args(argv)
    cfg, log = setup(args, "train_cascade")
    try:
        return train(args, cfg, log)
    finally:
        close_log(log)


def configure(cfg, stage: str, npoints: int, cascade=None) -> None:
    """The stage-2 config of a stage: RPN off, IOUN on for ioun, crops of
    `npoints` with the SA NPOINTS scaled down below 512."""
    cfg.RPN.ENABLED = False
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = stage == "ioun"
    if cascade:
        cfg.CASCADE = cascade
    cfg.RCNN.NUM_POINTS = npoints
    if npoints < 512:
        scale = 512 // npoints
        cfg.RCNN.SA_CONFIG.NPOINTS = [max(256 // scale, 4),
                                      max(128 // scale, 2),
                                      max(32 // scale, 1), -1]
        cfg.IOUN.SA_CONFIG.NPOINTS = cfg.RCNN.SA_CONFIG.NPOINTS


def train(args, cfg, log) -> int:
    from ws3d_tpu_torch.datasets import (BoxPlaceDataset,
                                         synthetic_proposal_database)
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training import (Trainer, load_part_checkpoint,
                                         save_train_state)
    from ws3d_tpu_torch.weights import save_npz

    stage = STAGE_ALIASES[args.stage]
    configure(cfg, stage, args.npoints, args.cascade)
    if args.db:
        with open(args.db, "rb") as f:
            database = pickle.load(f)
        if not database:
            raise SystemExit(f"{args.db}: the proposal database holds no "
                             f"records")
    else:
        database = synthetic_proposal_database(num=args.db_size,
                                               seed=args.seed,
                                               crop_points=args.npoints)
    ds = BoxPlaceDataset(database, cfg, mode="TRAIN", npoints=args.npoints,
                         seed=args.seed, weakly_ratio=args.weakly_ratio)
    log.info("stage-2 dataset: %d samples (stage=%s cascade=%d)", len(ds),
             stage, cfg.CASCADE)

    model = build_model(cfg, device="cpu" if args.cpu else args.device,
                        seed=args.seed)
    if args.ckpt:
        n = load_part_checkpoint(model, args.ckpt, subtrees=("rcnn",))
        log.info("loaded %d rcnn tensors from %s", n, args.ckpt)
    trainer = Trainer(model, cfg, total_steps=args.steps, stage=stage,
                      seed=args.seed, log_fn=log.info)
    log.info("device: %s", trainer.device)
    epoch_size = max(len(ds) // args.batch, 1)
    total_epochs = max(args.steps // epoch_size, 1)

    def batches():
        count = 0
        while count < args.steps:
            ratio = trainer.prob_mask_ratio(count // epoch_size,
                                            total_epochs)
            for b in ds.batches(args.batch, steps=epoch_size,
                                prob_mask_ratio=ratio):
                yield b
                count += 1
                if count >= args.steps:
                    return

    trainer.train_steps(batches(), total_steps=args.steps,
                        log_every=max(args.steps // 100, 1),
                        epoch_size=epoch_size, ckpt_dir=args.output_dir)
    trainer.recalibrate_bn(ds.batches(args.batch, steps=20))

    ckpt = save_train_state(os.path.join(args.output_dir,
                                         f"{stage}_ckpt.pt"),
                            model, trainer.optimizer)
    log.info("saved checkpoint: %s", ckpt)
    npz = os.path.join(args.output_dir, f"{stage}_weights.npz")
    save_npz(model, npz)
    log.info("saved weights: %s", npz)
    return 0


if __name__ == "__main__":
    sys.exit(main())
