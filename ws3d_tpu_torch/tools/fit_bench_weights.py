"""Fit a full set of detector weights on the port (the flow of
tools/fit_bench_weights.py) and write them as one flat npz.

    python -m ws3d_tpu_torch.tools.fit_bench_weights --out weights.npz
    python -m ws3d_tpu_torch.tools.fit_bench_weights --out w.npz \\
        --rpn_steps 300 --rcnn_steps 500 --ioun_steps 300 --scenes 16

Runs the synthetic weak-label flow: train_rpn, generate_box_dataset on the
trained RPN, train_cascade --stage rcnn on that database, then
train_cascade --stage ioun from the RCNN checkpoint; then builds the
two-stage model (RCNN and IOUN enabled), loads the IOUN checkpoint's rpn and
rcnn entries and the RPN checkpoint's rpn entries, and writes it with
weights.save_npz (the JAX package's flat keys, float32; it loads into the
JAX package through ws3d_tpu/utils/npz_overlay.py). --from_ckpts RPN IOUN
skips the training. --out is required and may not lie inside ws3d_tpu/:
ws3d_tpu/data/bench_weights.npz is the JAX package's fixed yardstick.
Runs on CUDA unless --device cpu. The stage checkpoints go to --workdir (a
temporary directory, removed at the end, when not given).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
FROZEN = os.path.join(REPO, "ws3d_tpu")


def check_out(out: str) -> str:
    """The absolute --out path; raises SystemExit for one inside
    ws3d_tpu/."""
    path = os.path.realpath(out)
    frozen = os.path.realpath(FROZEN)
    if os.path.commonpath([path, frozen]) == frozen:
        raise SystemExit(f"--out {out}: refusing to write inside {FROZEN} "
                         f"(the JAX package's weights stay as they are)")
    return path


def convert(rpn_ckpt: str, ioun_ckpt: str, out: str, device=None) -> int:
    """Write the two-stage weights of the two checkpoints to `out`; returns
    the number of arrays."""
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training import load_part_checkpoint
    from ws3d_tpu_torch.weights import save_npz
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    model = build_model(cfg, device=device)
    load_part_checkpoint(model, ioun_ckpt, subtrees=("rpn", "rcnn"))
    load_part_checkpoint(model, rpn_ckpt, subtrees=("rpn",))
    os.makedirs(os.path.dirname(out), exist_ok=True)
    count = save_npz(model, out)
    print(f"wrote {out}: {count} arrays, {os.path.getsize(out) / 1e6:.1f} MB",
          flush=True)
    return count


def run(tool, argv) -> None:
    print("+ " + tool.__name__ + " " + " ".join(argv), flush=True)
    rc = tool.main(argv)
    if rc:
        raise SystemExit(f"{tool.__name__} exited with {rc}")


def fit(args, wd: str, device=None) -> None:
    """The four training runs, their outputs under `wd`."""
    from ws3d_tpu_torch.tools import (generate_box_dataset, train_cascade,
                                      train_rpn)
    dev = ["--device", device] if device else []
    db = os.path.join(wd, "train_boxes.pkl")
    run(train_rpn, ["--synthetic", "--steps", str(args.rpn_steps),
                    "--batch", str(args.batch), "--scenes", str(args.scenes),
                    "--output_dir", wd] + dev)
    run(generate_box_dataset, ["--synthetic", "--ckpt",
                               os.path.join(wd, "rpn_ckpt.pt"), "--scenes",
                               str(args.scenes), "--output_dir", wd,
                               "--out", db] + dev)
    run(train_cascade, ["--stage", "rcnn", "--synthetic", "--steps",
                        str(args.rcnn_steps), "--db", db, "--output_dir",
                        wd] + dev)
    run(train_cascade, ["--stage", "ioun", "--synthetic", "--steps",
                        str(args.ioun_steps), "--db", db, "--ckpt",
                        os.path.join(wd, "rcnn_ckpt.pt"), "--output_dir",
                        wd] + dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=str, required=True,
                   help="npz path (not inside ws3d_tpu/)")
    p.add_argument("--rpn_steps", type=int, default=3000)
    p.add_argument("--rcnn_steps", type=int, default=20000)
    p.add_argument("--ioun_steps", type=int, default=8000)
    p.add_argument("--scenes", type=int, default=96)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--from_ckpts", nargs=2, default=None,
                   metavar=("RPN_CKPT", "IOUN_CKPT"))
    p.add_argument("--device", type=str, default=None)
    args = p.parse_args(argv)
    out = check_out(args.out)
    if args.from_ckpts:
        convert(*args.from_ckpts, out, args.device)
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        wd = args.workdir or tmp
        fit(args, wd, args.device)
        convert(os.path.join(wd, "rpn_ckpt.pt"),
                os.path.join(wd, "ioun_ckpt.pt"), out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
