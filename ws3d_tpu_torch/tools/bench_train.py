"""Train-step throughput of the port on the card: the counterpart of the JAX
package's tools/bench_train.py.

    python -m ws3d_tpu_torch.tools.bench_train [--stages rpn,rcnn,ioun]
        [--reps 8] [--rpn_batch 25] [--stage2_batch 800]
        [--stage2_points 512] [--split]

Runs on CUDA only (there is no CPU mode; it raises without a card). The
shapes are the JAX tool's, the reference's training shapes: stage 1 at 25
scenes of 16,384 points, RCNN and IOUN at 800 crops of 512 points. Each
stage starts from the port's seeded init (seed 0), AdamOneCycle over 1,000
steps on the stage's trainable parameters, dropout from a generator seeded
1 and BN momentum 0.1. Its one input batch (the first of RPNDataset(TRAIN)
over SyntheticKitti(seed=0, 18,000 points a scene), or of BoxPlaceDataset
(TRAIN) over synthetic_proposal_database) is timed on the host
(host_ms_per_batch) and moved to the card once.

A step's time is (t_n - t_1) / (n - 1) with n = --reps: t_1 is the best of
3 one-step runs and t_n the best of 2 n-step runs, after one warm-up run of
each. A run is a Python loop of train steps on the batch, each threading
the optimizer and BatchNorm state on to the next, as the JAX tool's
fori_loop threads its TrainState; it is closed by torch.cuda.synchronize()
and a host read of its last loss, which must be finite. The runs continue
from each other's state (the JAX tool restarts each from the same state;
the step's work does not depend on it). With --split a forward-only loop
(the stage's loss function under torch.no_grad(), the same train-mode
forward: the same kernels are launched, which the tool checks by their
launch counts) and a gradients-only loop (rpn_gradients or rcnn_gradients,
no optimizer step) are timed the same way: fwd_ms, bwd_ms = gradients -
forward, optimizer_ms = step - gradients. The forward-only loop updates the
BatchNorm running statistics in place, as every train-mode forward does
(JAX's discards them); nothing timed reads them.

The JAX tool's perturbation of the loop body (_float_key and the 1e-30
nudge of the network input) is not ported: it only stops XLA hoisting a
loop-invariant body out of the fori_loop, and eager PyTorch hoists nothing.

Prints, a stage, its peak memory on a line of its own and then one JSON
line with the JAX tool's keys plus `device` (the card's name and power
limit). With more than one stage each runs in a subprocess of its own, as
the JAX tool does.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
BN_MOMENTUM = 0.1
TOTAL_STEPS = 1000          # the optimizer's schedule length


@dataclass
class StageBench:
    """One stage's model, optimizer, step, loss and gradient functions and
    its input batch, on one device."""
    stage: str
    cfg: object
    model: torch.nn.Module
    host_batch: Dict[str, np.ndarray]
    batch: Dict[str, torch.Tensor]
    host_s: float
    optimizer: object
    step: Callable
    loss_fn: Callable
    gradients: Callable
    generator: torch.Generator


def stage2_config(stage: str, points: int):
    """The JAX tool's stage-2 config: RPN off, RCNN on, IOUN on for stage
    ioun, RCNN.NUM_POINTS `points`."""
    from ws3d_tpu_torch.config import load_config
    cfg = load_config()
    cfg.RPN.ENABLED = False
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = stage == "ioun"
    cfg.RCNN.NUM_POINTS = points
    return cfg


def _first_batch(ds, batch: int):
    """(the loader's first batch, its host seconds)."""
    t0 = time.perf_counter()
    host = next(ds.batches(batch, shuffle=True))
    return host, time.perf_counter() - t0


def _stage_bench(stage, cfg, model, host, host_s, device) -> StageBench:
    from ws3d_tpu_torch.training.optim import AdamOneCycle
    from ws3d_tpu_torch.training.trainer import (
        batch_to_device, make_rcnn_loss_fn, make_rcnn_train_step,
        make_rpn_loss_fn, make_rpn_train_step, rcnn_gradients, rpn_gradients,
        step_inputs, trainable_parameters)
    optimizer = AdamOneCycle(cfg, TOTAL_STEPS,
                             trainable_parameters(model, stage).items())
    generator = torch.Generator(device=device)
    generator.manual_seed(1)
    if stage == "rpn":
        step = make_rpn_train_step(model, cfg, optimizer)
        loss_fn = make_rpn_loss_fn(model, cfg)

        def gradients(b, gen):
            return rpn_gradients(model, cfg, b, gen, BN_MOMENTUM,
                                 optimizer.params)
    else:
        step = make_rcnn_train_step(model, cfg, optimizer, stage)
        loss_fn = make_rcnn_loss_fn(model, cfg, stage)

        def gradients(b, gen):
            return rcnn_gradients(model, cfg, stage, b, gen, BN_MOMENTUM,
                                  optimizer.params)
    batch = batch_to_device(host, device, step_inputs(stage, host))
    return StageBench(stage, cfg, model, host, batch, host_s, optimizer,
                      step, loss_fn, gradients, generator)


def rpn_bench(cfg, batch: int, device) -> StageBench:
    """Stage 1 on `device`: the seeded model and the first TRAIN batch of
    `batch` scenes."""
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models import build_model
    src = SyntheticKitti(num_scenes=max(batch, 8), points_per_scene=18000,
                         seed=0)
    host, host_s = _first_batch(RPNDataset(src, cfg, mode="TRAIN", seed=0),
                                batch)
    model = build_model(cfg, device=device, seed=0)
    return _stage_bench("rpn", cfg, model, host, host_s, device)


def stage2_bench(cfg, stage: str, batch: int, points: int,
                 device) -> StageBench:
    """Stage 2 (rcnn or ioun) on `device`: the seeded model and the first
    TRAIN batch of `batch` crops of `points` points."""
    from ws3d_tpu_torch.datasets import (BoxPlaceDataset,
                                         synthetic_proposal_database)
    from ws3d_tpu_torch.models import build_model
    db = synthetic_proposal_database(num=max(64, batch // 4), seed=0,
                                     crop_points=points)
    ds = BoxPlaceDataset(db, cfg, mode="TRAIN", npoints=points, seed=0)
    host, host_s = _first_batch(ds, batch)
    model = build_model(cfg, device=device, seed=0)
    return _stage_bench(stage, cfg, model, host, host_s, device)


def _timed(run: Callable[[int], torch.Tensor], n: int) -> float:
    """Seconds of run(n), closed by a synchronize and a host read of the
    last loss, which must be finite."""
    t0 = time.perf_counter()
    loss = run(n)
    if loss.is_cuda:
        torch.cuda.synchronize(loss.device)
    value = float(loss)
    seconds = time.perf_counter() - t0
    if not math.isfinite(value):
        raise FloatingPointError(f"non-finite loss {value}")
    return seconds


def measure(run: Callable[[int], torch.Tensor], reps: int) -> float:
    """Seconds a step, (t_n - t_1) / (n - 1) with n = reps."""
    _timed(run, 1)
    _timed(run, reps)
    t1 = min(_timed(run, 1) for _ in range(3))
    tn = min(_timed(run, reps) for _ in range(2))
    return (tn - t1) / (reps - 1)


def step_loop(b: StageBench) -> Callable[[int], torch.Tensor]:
    """n train steps; the last loss."""
    def run(n: int) -> torch.Tensor:
        for _ in range(n):
            aux = b.step(b.batch, b.generator, BN_MOMENTUM)
        return aux["loss"]
    return run


def forward_loop(b: StageBench) -> Callable[[int], torch.Tensor]:
    """n train-mode forwards and losses under torch.no_grad()."""
    def run(n: int) -> torch.Tensor:
        with torch.no_grad():
            for _ in range(n):
                loss, _ = b.loss_fn(b.batch, b.generator, BN_MOMENTUM)
        return loss
    return run


def gradient_loop(b: StageBench) -> Callable[[int], torch.Tensor]:
    """n forwards and backwards, no optimizer step."""
    def run(n: int) -> torch.Tensor:
        for _ in range(n):
            loss, _, _ = b.gradients(b.batch, b.generator)
        return loss
    return run


def _launches(fn: Callable[[], object]) -> dict:
    """The kernel launches fn() adds to the wrappers' counts (none on CPU
    tensors)."""
    from ws3d_tpu_torch.ops import _kernels
    before = dict(_kernels.LAUNCHES)
    fn()
    return {k: v - before[k] for k, v in _kernels.LAUNCHES.items()
            if v != before[k]}


def forward_launches(b: StageBench) -> dict:
    """The kernel launches of one loss-function forward with autograd on
    (the step's forward) and under torch.no_grad() (the forward-only
    loop's); raises if they differ."""
    def forward(grad: bool):
        with torch.set_grad_enabled(grad):
            b.loss_fn(b.batch, b.generator, BN_MOMENTUM)
    step = _launches(lambda: forward(True))
    alone = _launches(lambda: forward(False))
    if step != alone:
        raise RuntimeError(f"{b.stage}: the forward-only loop launches "
                           f"{alone}, the step's forward {step}")
    return step


def timings(b: StageBench, reps: int, split: bool) -> tuple:
    """(seconds a step, {device_ms_per_step, steps_per_sec} and with
    `split` fwd_ms, bwd_ms and optimizer_ms, rounded as the JAX tool
    rounds them)."""
    sec = measure(step_loop(b), reps)
    res = {"device_ms_per_step": round(sec * 1e3, 2),
           "steps_per_sec": round(1.0 / sec, 2)}
    if split:
        fwd = measure(forward_loop(b), reps)
        vg = measure(gradient_loop(b), reps)
        res["fwd_ms"] = round(fwd * 1e3, 2)
        res["bwd_ms"] = round((vg - fwd) * 1e3, 2)
        res["optimizer_ms"] = round((sec - vg) * 1e3, 2)
    return sec, res


def bench_stage(args, stage: str, device) -> tuple:
    """One stage at the arguments' shapes on `device`: (its JSON record
    less `device`, the kernel launches of one more step)."""
    from ws3d_tpu_torch.config import load_config
    if stage == "rpn":              # the JAX tool's stage 1: the defaults
        b = rpn_bench(load_config(), args.rpn_batch, device)
        size, points = args.rpn_batch, int(b.cfg.RPN.NUM_POINTS)
    else:
        b = stage2_bench(stage2_config(stage, args.stage2_points), stage,
                         args.stage2_batch, args.stage2_points, device)
        size, points = args.stage2_batch, args.stage2_points
    if args.split:
        forward_launches(b)
    sec, t = timings(b, args.reps, args.split)
    unit = "scenes_per_sec_train" if stage == "rpn" else \
        "crops_per_sec_train"
    res = {"stage": stage, "batch": size, "points": points,
           "device_ms_per_step": t.pop("device_ms_per_step"),
           "steps_per_sec": t.pop("steps_per_sec"),
           unit: round(size / sec, 1),
           "host_ms_per_batch": round(b.host_s * 1e3, 1)}
    res.update(t)
    return res, _launches(lambda: b.step(b.batch, b.generator, BN_MOMENTUM))


def stage_commands(args) -> list:
    """One command a stage, each running this tool on that stage alone."""
    cmds = []
    for stage in args.stages.split(","):
        cmd = [sys.executable, "-m", "ws3d_tpu_torch.tools.bench_train",
               "--stages", stage, "--reps", str(args.reps),
               "--rpn_batch", str(args.rpn_batch),
               "--stage2_batch", str(args.stage2_batch),
               "--stage2_points", str(args.stage2_points)]
        if args.split:
            cmd.append("--split")
        cmds.append(cmd)
    return cmds


def _reps(v: str) -> int:
    # measure amortizes as (t_n - t_1)/(reps - 1): reps == 1 divides by 0
    n = int(v)
    if n < 2:
        raise argparse.ArgumentTypeError("--reps must be >= 2")
    return n


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stages", default="rpn,rcnn,ioun")
    p.add_argument("--reps", type=_reps, default=8)
    p.add_argument("--rpn_batch", type=int, default=25)
    p.add_argument("--stage2_batch", type=int, default=800)
    p.add_argument("--stage2_points", type=int, default=512)
    p.add_argument("--split", action="store_true",
                   help="also time forward-only and fwd+bwd loops for a "
                        "split (fwd_ms/bwd_ms/optimizer_ms)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if len(args.stages.split(",")) > 1:
        # one process a stage: no stage's memory or kernels' state reaches
        # the next (the JAX tool's third stage ran out of HBM without this)
        for cmd in stage_commands(args):
            subprocess.run(cmd, check=True, cwd=ROOT)
        return 0
    from ws3d_tpu_torch.device import card_line, resolve_device
    device = resolve_device()           # the card; raises without one
    torch.cuda.reset_peak_memory_stats(device)
    res, launches = bench_stage(args, args.stages, device)
    res["device"] = card_line(device.index)
    print(f"# {args.stages}: peak memory "
          f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated); launches a step {launches}",
          flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
