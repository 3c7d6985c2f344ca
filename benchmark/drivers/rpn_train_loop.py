"""Stage-1 RPN training as train_rpn runs it: the port's
Trainer(stage="rpn") with AdamOneCycle, its train_steps loop and its
prefetch thread over RPNDataset(TRAIN) with the GT-database augmentation.

Set-up: `scenes` synthetic scenes generated and held in memory
(benchmark/gen/weak_scenes.py), the program's GT database built from the
first `weakly_num` of them that have weak labels, the program's loader
(RPNDataset, TRAIN, weakly_num, that database, its seed drawn from the
run's), the model on the card with weights the benchmark draws there from
the seed (benchmark/reference/rpn_train.rpn_initial_weights), and the
Trainer. With `prebuilt` > 0 the feed cycles that many batches the loader
built in set-up (the loader bypassed, the copy to the card kept); else the
feed is the loader itself. As in train_loop: the first `check_steps` steps
are the check of outputs' steps, `warmup` more follow, and the window is
one more train_steps call whose feed ends at the deadline; its time, to
the end of its last step on the card, over the steps it completed is
train_step_ms with the loader in the loop and prebuilt_step_ms on
pre-built batches.

A traced run adds `bench::` spans around the backbone's SA modules (`sa`)
and FP modules (`fp`), the ball query (`ball_query`, kernel 6) and the
3-NN search (`three_nn`, kernel 7, the interpolation's backward) with
their inputs as notes, whose counts (benchmark/roofline/stage1_counts.py)
are taken after the stretch, and FPS (`fps`).
"""
from __future__ import annotations

import math
import sys
import time
from contextlib import ExitStack

import numpy as np
import torch

from benchmark import harness, trace
from benchmark.drivers.infer_loop import wrap_kernels
from benchmark.drivers.train_loop import Feed, cycle, step_numbers
from benchmark.gen.scenes import sub_seed
from benchmark.gen.weak_scenes import HeldScenes
from benchmark.roofline import counts, stage1_counts

SEED_MAX = 2**31 - 1
CHECK_KEYS = ("pts_input", "rpn_cls_label", "rpn_reg_label", "gt_boxes3d",
              "gt_centers", "gt_count")


def scenes_of(ctx) -> HeldScenes:
    tr = ctx.traffic
    return HeldScenes(int(tr["scenes"]), sub_seed(ctx.seed, "scenes"),
                      max_cars=int(tr["max_cars"]),
                      points_per_scene=int(tr["points_per_scene"]))


def run(ctx) -> dict:
    from ws3d_tpu_torch.datasets.gt_database import build_gt_database
    from ws3d_tpu_torch.datasets.rpn_dataset import RPNDataset
    from ws3d_tpu_torch.models.detector import PointRCNN
    from ws3d_tpu_torch.training.trainer import Trainer
    from benchmark.reference.rpn_train import rpn_initial_weights
    tr = ctx.traffic
    tree = ctx.cfg_tree
    cfg = harness.program_config(ctx.cell)
    device = torch.device(ctx.device) if ctx.device else torch.device(
        "cuda", 0)
    on_card = device.type == "cuda"
    B, weakly = int(tr["batch"]), int(tr["weakly_num"])
    scenes = scenes_of(ctx)
    loader_seed = sub_seed(ctx.seed, "loader", SEED_MAX)
    weak = RPNDataset(scenes, cfg, mode="TRAIN", weakly_num=weakly,
                      seed=loader_seed)
    db = build_gt_database(scenes, weak.sample_ids)
    ds = RPNDataset(scenes, cfg, mode="TRAIN", weakly_num=weakly,
                    seed=loader_seed, gt_database=db)
    source = ds.batches(B, shuffle=True)
    if int(tr["prebuilt"]):
        source = cycle([next(source) for _ in range(int(tr["prebuilt"]))])
    feed = Feed(source)

    model = PointRCNN(cfg).to(device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w_seed = sub_seed(ctx.seed, "weights", SEED_MAX)
    model.load_state_dict(rpn_initial_weights(shapes, w_seed, device))
    model.train()
    dropout_seed = sub_seed(ctx.seed, "dropout", SEED_MAX)
    trainer = Trainer(model, cfg, int(tr["total_steps"]), stage="rpn",
                      seed=dropout_seed,
                      log_fn=lambda msg: print("# " + msg, file=sys.stderr))
    n_check = int(tr["check_steps"])
    state = instrument(ctx, model, trainer, feed, n_check)
    prefetch = int(tr["prefetch"])
    epoch = max(len(ds) // B, 1)
    hist = trainer.train_steps(feed, n_check, log_every=1, epoch_size=epoch,
                               prefetch_size=prefetch)
    prog_losses = [h["loss"] for h in hist]
    trainer.train_steps(feed, int(tr["warmup"]), log_every=10**9,
                        epoch_size=epoch, prefetch_size=prefetch)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    print(f"# card {harness.card_note() if on_card else 'cpu'}; batch {B} "
          f"scenes of {cfg.RPN.NUM_POINTS} points, {len(ds)} weak scenes, "
          f"GT database {len(db[0])} easy + {len(db[1])} hard, prebuilt "
          f"{tr['prebuilt']}", flush=True)

    record = {}
    state["record"] = record
    state["stack"] = ExitStack()
    state["trace_at"] = (int(tr.get("trace_start", 2)),
                         int(tr.get("trace_iters", 8))) if ctx.trace else None
    state["window_steps"] = 0
    steps0 = trainer.step
    t_first = time.perf_counter()
    setup_s = t_first - ctx.t_start
    feed.deadline = t_first + ctx.seconds
    if ctx.trace:       # a traced run goes on until its stretch is whole
        feed.hold = lambda: state["traced"] < state["trace_at"][1]
    try:
        trainer.train_steps(feed, 10**9, log_every=10**9, epoch_size=epoch,
                            prefetch_size=prefetch)
    finally:
        state["stack"].close()
    if on_card:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t_first
    steps = trainer.step - steps0
    last = float(state["last_aux"]["loss"])
    dev = harness.device_fields(device, record if ctx.trace else None)
    if ctx.trace:
        n = max(state["traced"], 1)
        host = dict(ctx.spans.host)
        calls = {k: list(v) for k, v in ctx.spans.calls.items()}
        ctx.spans.reset()           # the notes' tensors go with the counts
        calls["ball_query"] = [stage1_counts.ball_query_counts(**c)
                               for c in calls.get("ball_query", [])]
        calls["three_nn"] = [stage1_counts.three_nn_counts(**c)
                             for c in calls.get("three_nn", [])]
        record.update({"kind": "train", "iters": n, "host_s": host,
                       "calls": calls,
                       "loader_s": list(state["loader_s"]),
                       "flops": n * counts.rpn_flops(tree, B)})
    prog = {"losses": prog_losses, "first_grad": state["first_grad"],
            "params": state["params"],
            "batches": [{k: b[k] for k in CHECK_KEYS}
                        for b in state["batches"]],
            "numbers": [feed.index[id(b)] for b in state["batches"]]}
    del trainer, model, feed, state, ds, weak, db
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check_numbers(ctx, prog, scenes, loader_seed, w_seed,
                            dropout_seed, shapes, device)
    print(f"# the check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr, flush=True)
    from benchmark.reference.compare import verdict
    out = verdict(numbers, tr["limits"])
    print(f"# {steps} steps in {seconds:.3f} s, last loss {last}; peak "
          f"{dev['memory_peak_bytes'] / 2**30:.2f} GiB", flush=True)
    step_ms = seconds * 1e3 / max(steps, 1)
    return {"attempted": steps, "failed": 0 if math.isfinite(last) else 1,
            "end_to_end": {"train_step_ms": step_ms,
                           "prebuilt_step_ms": step_ms, "setup_s": setup_s},
            "device": dev, "record": record, **out}


def instrument(ctx, model, trainer, feed, n_check: int) -> dict:
    """Wraps the Trainer's step for the check's snapshots and the traced
    stretch, its host-batch hand-over for the batches the check's steps
    consumed, and the backward, the backbone's modules and the counted
    kernels for their spans."""
    import ws3d_tpu_torch.ops.ball_query as bq
    import ws3d_tpu_torch.ops.fused_sa as fsa
    import ws3d_tpu_torch.ops.interpolate as interp
    import ws3d_tpu_torch.ops.sampling as smp
    sp = ctx.spans
    state = {"batches": [], "first_grad": None, "params": None,
             "traced": 0, "loader_s": [], "trace_at": None,
             "window_steps": None}
    to_device = trainer._step_batch

    def step_batch(batch):
        if len(state["batches"]) < n_check:
            state["batches"].append(batch)
        return to_device(batch)
    trainer._step_batch = step_batch
    step_fn = sp.wrap("step", trainer.step_fn)
    opt = trainer.optimizer

    def step(batch, generator, bn_momentum=0.1):
        at, w = state["trace_at"], state["window_steps"]
        if at and w == at[0]:
            feed.timing = True
            feed.loader_s.clear()
            state["stack"].enter_context(trace.profiled(
                sp, state["record"], batch["pts_input"].is_cuda))
        aux = step_fn(batch, generator, bn_momentum)
        state["last_aux"] = aux
        if opt.count == 1 and state["first_grad"] is None:
            b1 = opt.mom(0)
            state["first_grad"] = {k: (v / (1.0 - b1)).detach().clone()
                                   for k, v in opt.mu.items()}
        if opt.count == n_check and state["params"] is None:
            state["params"] = {k: p.detach().clone()
                               for k, p in opt.params.items()}
        if w is not None:
            state["window_steps"] = w + 1
            if at and at[0] <= w < at[0] + at[1]:
                state["traced"] += 1
                if w == at[0] + at[1] - 1:
                    state["stack"].close()
                    feed.timing = False
                    state["loader_s"] = list(feed.loader_s)
        return aux
    trainer.step_fn = step
    torch.autograd.grad = sp.wrap("backward", torch.autograd.grad)
    wrap_kernels(sp, fsa, smp)
    backbone = model.rpn.backbone
    for name, mod in backbone.named_children():
        kind = name.split("_")[0]
        mod.forward = sp.wrap(kind, mod.forward)
    bq.ball_query_multi_cuda = sp.wrap(
        "ball_query", bq.ball_query_multi_cuda,
        lambda radii, nsamples, xyz, new_xyz: {
            "radii": [float(r) for r in radii],
            "nsamples": [int(s) for s in nsamples], "xyz": xyz,
            "new_xyz": new_xyz})
    interp.three_nn_cuda = sp.wrap(
        "three_nn", interp.three_nn_cuda,
        lambda unknown, known, bounds=None: {
            "unknown": unknown, "known": known, "prepass": bounds is None})
    return state


def check_numbers(ctx, prog, scenes, loader_seed, w_seed, dropout_seed,
                  shapes, device) -> dict:
    """The reference's loader batches and steps beside the program's."""
    from benchmark.reference.net import f32_matmuls
    from benchmark.reference.rpn_loader import RPNTrainLoader
    from benchmark.reference.rpn_train import (INPUTS, rpn_initial_weights,
                                               run_steps, split)
    tr, tree = ctx.traffic, ctx.cfg_tree
    loader = RPNTrainLoader(scenes, tree, int(tr["weakly_num"]), loader_seed)
    it = loader.batches(int(tr["batch"]))
    cyc = int(tr["prebuilt"]) or max(prog["numbers"]) + 1
    numbers = [n % cyc for n in prog["numbers"]]
    built = [next(it) for _ in range(max(numbers) + 1)]
    built = [built[n] for n in numbers]
    print(f"# GT aug pasted {[int(b['pasted'].sum()) for b in built]} "
          f"boxes a checked batch", file=sys.stderr, flush=True)
    mismatch = sum(int(np.sum(np.asarray(b[k]) != np.asarray(p[k])))
                   + abs(np.asarray(b[k]).size - np.asarray(p[k]).size)
                   for b, p in zip(built, prog["batches"])
                   for k in CHECK_KEYS)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(b[k])).to(device)
                for k in INPUTS} for b in built]
    state = rpn_initial_weights(shapes, w_seed, device)
    p0 = {k: v.clone() for k, v in split(state)[0].items()}
    with f32_matmuls():
        ref = run_steps(state, tree, batches, int(tr["total_steps"]),
                        dropout_seed)
    return step_numbers(prog, ref, p0, mismatch)
