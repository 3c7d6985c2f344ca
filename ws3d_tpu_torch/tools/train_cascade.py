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
Runs on CUDA unless --device cpu.

With --val_ratio R (default 0.1; 0 turns it off) and a database of 8 or
more records, max(int(len * R), 2) records (a RandomState(666)
permutation, as the JAX tool draws it) are held out and validated every
--val_every steps (default steps // 20) and after the last step: the IoU
recall of the held-out crops' boxes (IOUN: of the refined boxes, and the
predicted-IoU error), logged as `val @ step i:`, each eval saved as
OUTPUT_DIR/<stage>_ckpt_e{k}.pt and the best as <stage>_ckpt_best.pt, the
scalars in OUTPUT_DIR/tb/scalars.jsonl.

With --profile_dir DIR the training loop runs under torch.profiler:
DIR/trace.json holds the trace, the program's ws3d:: spans among the
kernels, and DIR/spans.json the spans (the prefetch thread's too), their
totals and the counters (ws3d_tpu_torch.utils.profiling).
"""
from __future__ import annotations

import os
import pickle
import sys

import numpy as np

from ws3d_tpu_torch.tools.train_rpn import base_parser, close_log, setup
from ws3d_tpu_torch.utils.profiling import trace_context

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
    p.add_argument("--val_ratio", type=float, default=0.1,
                   help="held-out fraction of the database for in-training "
                        "eval (0 disables)")
    p.add_argument("--val_every", type=int, default=None,
                   help="eval cadence in steps (default total/20)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="profile the training loop into DIR/trace.json "
                        "and DIR/spans.json")
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


def split_database(database, val_ratio: float):
    """-> (train records, held-out records): max(int(len * val_ratio), 2)
    records of a RandomState(666) permutation held out when val_ratio > 0
    and the database holds 8 or more records, else none."""
    if not val_ratio or len(database) < 8:
        return database, []
    order = np.random.RandomState(666).permutation(len(database))
    n_val = max(int(len(database) * val_ratio), 2)
    return ([database[i] for i in order[n_val:]],
            [database[i] for i in order[:n_val]])


def train(args, cfg, log) -> int:
    from ws3d_tpu_torch.datasets import (BoxPlaceDataset,
                                         synthetic_proposal_database)
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training import (Trainer, load_part_checkpoint,
                                         make_val_fn, save_train_state)
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
    database, val_db = split_database(database, args.val_ratio)
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
                      seed=args.seed, log_fn=log.info,
                      tb_dir=os.path.join(args.output_dir, "tb"))
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

    val_fn = None
    if val_db:
        val_ds = BoxPlaceDataset(val_db, cfg, mode="EVAL",
                                 npoints=args.npoints, seed=args.seed)
        val_bs = min(args.batch, len(val_ds))
        val_steps = max(len(val_ds) // val_bs, 1)
        val_fn = make_val_fn(cfg, stage,
                             lambda: val_ds.batches(val_bs, steps=val_steps,
                                                    shuffle=False))
        log.info("in-training val: %d held-out crops", len(val_ds))

    with trace_context(args.profile_dir):
        trainer.train_steps(batches(), total_steps=args.steps,
                            log_every=max(args.steps // 100, 1),
                            epoch_size=epoch_size, ckpt_dir=args.output_dir,
                            val_fn=val_fn, val_every=args.val_every)
    if trainer.best_val is not None:
        log.info("best val: %s", trainer.best_val)
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
