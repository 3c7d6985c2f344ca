"""Checkpoint sweep on the port (the flow of tools/eval_all_ckpt.py):
evaluate every {stage}_ckpt_e{k}.pt train state the Trainer wrote into a
directory (one a validation, training/trainer.py) and report the best by
the summed Car 3D AP (easy + moderate + hard).

    python -m ws3d_tpu_torch.tools.eval_all_ckpt --ckpt_dir output \\
        --synthetic --scenes 4 --points 4096 --cpu

In process (the default) it builds one model and one two-stage function,
and for each checkpoint resets the model to its seeded init and loads the
checkpoint's rpn and rcnn entries (load_part_checkpoint), then runs
eval_auto's run_eval into OUTPUT_DIR/<checkpoint name>/. --subprocess runs
`python -m ws3d_tpu_torch.tools.eval_auto --ckpt <checkpoint>` per
checkpoint instead and reads its "Car 3D AP e/m/h" line. Checkpoints are
taken in (stage, k) order; the results and the best go to
OUTPUT_DIR/ckpt_sweep.json. Runs on CUDA unless --cpu (or --device cpu).
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

from ws3d_tpu_torch.tools.train_rpn import (base_parser, close_log,
                                            make_scene_source, setup)

CKPT = re.compile(r"^(\w+)_ckpt_e(\d+)\.pt$")
AP_LINE = "Car 3D AP e/m/h:"


def find_checkpoints(ckpt_dir: str) -> list:
    """The {stage}_ckpt_e{k}.pt files of `ckpt_dir`, in (stage, k) order."""
    found = []
    for name in os.listdir(ckpt_dir):
        m = CKPT.match(name)
        if m and os.path.isfile(os.path.join(ckpt_dir, name)):
            found.append((m.group(1), int(m.group(2)), name))
    return [os.path.join(ckpt_dir, name) for _, _, name in sorted(found)]


def _out_dir(args, ckpt: str) -> str:
    return os.path.join(args.output_dir, os.path.basename(ckpt)[:-3])


def sweep_subprocess(args, cfg, log, ckpts) -> list:
    results = []
    for ckpt in ckpts:
        cmd = [sys.executable, "-m", "ws3d_tpu_torch.tools.eval_auto",
               "--ckpt", ckpt, "--scenes", str(args.scenes),
               "--batch", str(args.batch), "--seed", str(args.seed),
               "--output_dir", _out_dir(args, ckpt)]
        for flag, value in (("--data_root", args.data_root),
                            ("--points", args.points),
                            ("--cfg_file", args.cfg_file),
                            ("--device", args.device)):
            if value:
                cmd += [flag, str(value)]
        if args.synthetic:
            cmd.append("--synthetic")
        if args.cpu:
            cmd.append("--cpu")
        if args.set_cfgs:
            cmd += ["--set", *args.set_cfgs]
        log.info("evaluating %s", ckpt)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        score = None
        for line in (proc.stdout + proc.stderr).splitlines():
            if AP_LINE in line:
                score = sum(float(x) for x in
                            line.split(AP_LINE)[1].split("/"))
        if proc.returncode != 0:
            log.info("  eval_auto exited %d:\n%s", proc.returncode,
                     proc.stderr[-2000:])
        results.append({"ckpt": ckpt, "sum_3d_ap": score})
        log.info("  -> sum 3D AP: %s", score)
    return results


def sweep_inprocess(args, cfg, log, ckpts) -> list:
    from ws3d_tpu_torch.datasets import RPNDataset
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    from ws3d_tpu_torch.tools.eval_auto import configure, run_eval
    from ws3d_tpu_torch.training import load_part_checkpoint

    configure(cfg, args.points)
    src = make_scene_source(args, num_scenes=args.scenes)
    ds = RPNDataset(src, cfg, mode="EVAL", seed=args.seed)
    model = build_model(cfg, device="cpu" if args.cpu else args.device,
                        seed=args.seed)
    base = {k: v.clone() for k, v in model.state_dict().items()}
    fn = make_two_stage_fn(model, cfg)      # one function for every ckpt
    results = []
    for ckpt in ckpts:
        log.info("evaluating %s", ckpt)
        model.load_state_dict(base)
        load_part_checkpoint(model, ckpt, subtrees=("rpn", "rcnn"))
        ret = run_eval(model, cfg, src, ds, log, scenes=args.scenes,
                       batch=args.batch, output_dir=_out_dir(args, ckpt),
                       fn=fn)
        score = float(ret["Car_3d_easy"] + ret["Car_3d_moderate"]
                      + ret["Car_3d_hard"])
        results.append({"ckpt": ckpt, "sum_3d_ap": score})
        log.info("  -> sum 3D AP: %s", score)
    return results


def main(argv=None) -> int:
    p = base_parser("sweep checkpoints, pick the best by summed 3D AP")
    p.add_argument("--ckpt_dir", type=str, required=True)
    p.add_argument("--scenes", type=int, default=8)
    p.add_argument("--points", type=int, default=None)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--subprocess", action="store_true",
                   help="one eval_auto process per checkpoint instead of "
                        "the in-process sweep")
    args = p.parse_args(argv)
    cfg, log = setup(args, "eval_all_ckpt")
    try:
        ckpts = find_checkpoints(args.ckpt_dir)
        if not ckpts:
            log.error("no {stage}_ckpt_e{k}.pt under %s", args.ckpt_dir)
            return 1
        sweep = sweep_subprocess if args.subprocess else sweep_inprocess
        results = sweep(args, cfg, log, ckpts)
        scored = [r for r in results if r["sum_3d_ap"] is not None]
        best = max(scored, key=lambda r: r["sum_3d_ap"]) if scored else None
        path = os.path.join(args.output_dir, "ckpt_sweep.json")
        with open(path, "w") as f:
            json.dump({"results": results, "best": best}, f, indent=2)
        log.info("best: %s", best)
        log.info("summary -> %s", path)
        return 0
    finally:
        close_log(log)


if __name__ == "__main__":
    sys.exit(main())
