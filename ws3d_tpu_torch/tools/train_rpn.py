"""Stage-1 (weak RPN) training on the port (the flow of tools/train_rpn.py).

    python -m ws3d_tpu_torch.tools.train_rpn --synthetic --steps 2 \\
        --batch 2 --points 2048 --device cpu

Trains the centre-vote RPN on Gaussian labels around the weak BEV clicks
with OneCycle Adam, gradient clip 1.0 and the BN-momentum decay, writes
resume checkpoints every --ckpt_every steps, re-estimates the BatchNorm
statistics at the final weights and saves OUTPUT_DIR/rpn_ckpt.pt (the train
state) and OUTPUT_DIR/rpn_weights.npz (the JAX package's flat keys). Runs on
CUDA unless --device cpu. Scenes come from the synthetic generator, or with
--data_root from a KITTI tree (its ImageSets/train.txt, the weak labels in
label_noise/).

With --val_scenes N (default 8; 0 turns it off) it validates every
--val_every steps (default steps // 20) and after the last step on N
synthetic scenes (seed + 1000), or on the tree's small_val split (else
val): the vote precision and gt recall, logged as `val @ step i:`, each
eval saved as OUTPUT_DIR/rpn_ckpt_e{k}.pt and the best as
rpn_ckpt_best.pt, the scalars in OUTPUT_DIR/tb/scalars.jsonl. Like the JAX
tool it builds no GT database (RPNDataset(gt_database=...) takes one).

With --mesh N it trains data parallel over N ranks (ws3d_tpu_torch.parallel):
N processes, one a visible GPU over NCCL, or with --cpu N gloo ranks on the
CPU; under torchrun (torchrun --nproc_per_node N -m
ws3d_tpu_torch.tools.train_rpn --mesh N ...) N must equal WORLD_SIZE.
--batch is the global batch and must divide by N; every rank builds it from
the same seed and trains on its slice. Rank 0 alone logs and writes to
OUTPUT_DIR.
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
                   help="KITTI root dir (object/, ImageSets/)")
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


def setup(args, name: str = "train_rpn", group=None):
    """(cfg, logger): the logger writes to stderr and OUTPUT_DIR/log.txt;
    on a rank other than 0 of a group it writes nowhere."""
    from ws3d_tpu_torch.config import load_config
    cfg = load_config(args.cfg_file, args.set_cfgs)
    if group is not None and not group.is_main:
        log = logging.getLogger(f"ws3d_tpu_torch.{name}.rank{group.rank}")
        log.propagate = False
        log.addHandler(logging.NullHandler())
        return cfg, log
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


def run_ranks(args, run) -> int:
    """run(args, group) -> exit code on args.mesh data-parallel ranks; rank
    0's code. Under torchrun this process is one rank (args.mesh must equal
    WORLD_SIZE); otherwise args.mesh processes start: gloo ranks on the CPU
    with --cpu or --device cpu, else one visible CUDA device a rank over
    NCCL, the kernels built once before the ranks start. `run` must be a
    module-level function."""
    from ws3d_tpu_torch.parallel import destroy_group, launch, make_mesh
    device = "cpu" if args.cpu else args.device
    if "WORLD_SIZE" in os.environ:
        group = make_mesh(args.mesh, device=device)
        try:
            return run(args, group)
        finally:
            destroy_group()
    # no deadline for the whole run: a hung collective fails on its own
    return launch(_rank_entry, args.mesh, run, args, device=device,
                  timeout=None)[0]


def _rank_entry(group, run, args) -> int:
    return run(args, group)


def make_scene_source(args, num_scenes: int = 64, points: int = 18000):
    """The synthetic generator, unless --data_root names a KITTI tree and
    --synthetic is not given: then the tree's `args.split` (train by
    default) through KittiRaw."""
    if args.synthetic or not args.data_root:
        from ws3d_tpu_torch.datasets import SyntheticKitti
        return SyntheticKitti(num_scenes=num_scenes, points_per_scene=points,
                              seed=args.seed)
    from ws3d_tpu_torch.datasets import KittiRaw
    return KittiRaw(args.data_root, split=getattr(args, "split", "train"))


def val_source(args):
    """The in-training validation scenes: --val_scenes synthetic scenes
    (seed + 1000), or with --data_root and no --synthetic the tree's
    small_val split, else (no scene listed there) its val split."""
    if args.synthetic or not args.data_root:
        from ws3d_tpu_torch.datasets import SyntheticKitti
        return SyntheticKitti(num_scenes=args.val_scenes,
                              points_per_scene=18000, seed=args.seed + 1000)
    from ws3d_tpu_torch.datasets import KittiRaw
    src = KittiRaw(args.data_root, split="small_val")
    return src if src.sample_ids else KittiRaw(args.data_root, split="val")


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
    p.add_argument("--val_scenes", type=int, default=8,
                   help="small_val scene count (0 disables in-training eval)")
    p.add_argument("--val_every", type=int, default=None,
                   help="eval cadence in steps (default total/20)")
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel over N ranks (0 = one process)")
    args = p.parse_args(argv)
    if args.mesh:
        if args.batch % args.mesh:
            raise SystemExit("--batch must be divisible by --mesh")
        return run_ranks(args, _run)
    return _run(args, None)


def _run(args, group) -> int:
    cfg, log = setup(args, group=group)
    try:
        return train(args, cfg, log, group)
    finally:
        close_log(log)


def train(args, cfg, log, group=None) -> int:
    from ws3d_tpu_torch.config import refuse_bf16_training
    refuse_bf16_training(cfg)       # training computes in f32 only
    if args.points:
        cfg.RPN.NUM_POINTS = args.points
        if args.points <= 2048:
            cfg.RPN.SA_CONFIG.NPOINTS = [args.points // 4, args.points // 16,
                                         args.points // 64, args.points // 256]

    from ws3d_tpu_torch.datasets import RPNDataset
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training import (Trainer, make_val_fn,
                                         restore_train_state,
                                         save_train_state)
    from ws3d_tpu_torch.weights import save_npz

    src = make_scene_source(args, num_scenes=args.scenes)
    ds = RPNDataset(src, cfg, mode="TRAIN",
                    weakly_num=args.weakly_num if not args.synthetic else None,
                    seed=args.seed)
    log.info("dataset: %d scenes, %d points/scene", len(ds),
             cfg.RPN.NUM_POINTS)

    device = group.device if group is not None else (
        "cpu" if args.cpu else args.device)
    model = build_model(cfg, device=device, seed=args.seed)
    trainer = Trainer(model, cfg, total_steps=args.steps, stage="rpn",
                      seed=args.seed, log_fn=log.info,
                      tb_dir=os.path.join(args.output_dir, "tb"),
                      group=group)
    log.info("device: %s", trainer.device)
    if group is not None:
        log.info("data parallel over %d ranks (%s), %d scenes a rank",
                 group.world_size, group.backend,
                 args.batch // group.world_size)
    epoch_size = max(len(ds) // args.batch, 1)
    if args.ckpt:
        step = restore_train_state(args.ckpt, model, trainer.optimizer)
        log.info("resumed from %s at step %d", args.ckpt, step)

    val_fn = None
    val_ds = (RPNDataset(val_source(args), cfg, mode="EVAL", seed=args.seed)
              if args.val_scenes else None)
    if val_ds is not None and len(val_ds):
        val_bs = min(args.batch, len(val_ds))
        val_steps = max(len(val_ds) // val_bs, 1)
        val_fn = make_val_fn(cfg, "rpn",
                             lambda: val_ds.batches(val_bs, steps=val_steps))
        log.info("in-training val: %d scenes", len(val_ds))
    elif val_ds is not None:
        log.info("in-training val: the tree lists no small_val or val "
                 "scene; no validation")

    trainer.train_steps(ds.batches(args.batch, shuffle=True),
                        total_steps=args.steps,
                        log_every=max(args.steps // 100, 1),
                        epoch_size=epoch_size, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.output_dir, val_fn=val_fn,
                        val_every=args.val_every)
    if trainer.best_val is not None:
        log.info("best val: %s", trainer.best_val)
    trainer.recalibrate_bn(ds.batches(args.batch, shuffle=True))
    if not trainer.is_main:
        return 0

    ckpt = save_train_state(os.path.join(args.output_dir, "rpn_ckpt.pt"),
                            model, trainer.optimizer)
    log.info("saved checkpoint: %s", ckpt)
    npz = os.path.join(args.output_dir, "rpn_weights.npz")
    save_npz(model, npz)
    log.info("saved weights: %s", npz)
    return 0


if __name__ == "__main__":
    sys.exit(main())
