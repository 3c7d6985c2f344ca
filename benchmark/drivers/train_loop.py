"""Stage-2 RCNN training as train_cascade runs it: the port's
Trainer(stage="rcnn") with AdamOneCycle, its train_steps loop and its
prefetch thread over a feed of host batches.

Set-up: the proposal database drawn from the seed, the program's loader
(BoxPlaceDataset, TRAIN, its seed drawn from the run's), the model on the
card with weights the benchmark draws there from the seed, and the
Trainer. With `prebuilt` > 0 the feed cycles that many batches the loader
built in set-up (the loader bypassed, the copy to the card kept); else
the feed is the loader itself. The first `check_steps` steps run through
the window's own call and feed and are the check of outputs' steps; the
optimizer's state after the first and the parameters after the last are
kept. `warmup` more steps follow. The window is one more train_steps call
whose feed ends at the deadline. The window's time, to the end of its
last step on the card, over the steps it completed is train_step_ms with
the loader in the loop and prebuilt_step_ms on pre-built batches (each
cell reports the one BENCHMARK.json lists for it).
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
from benchmark.gen.proposals import synthetic_proposal_database
from benchmark.gen.scenes import sub_seed
from benchmark.roofline import counts

SEED_MAX = 2**31 - 1


class Feed:
    """The host batches the Trainer draws: numbered, timed inside next()
    (the loader's time, on the prefetch thread), ending at `deadline`
    unless `hold()` says to go on."""

    def __init__(self, source):
        self.source = source
        self.deadline = None
        self.hold = lambda: False
        self.n = 0
        self.index = {}             # id(batch) -> its number
        self.timing = False
        self.loader_s = []

    def __iter__(self):
        return self

    def __next__(self):
        if self.deadline is not None and time.perf_counter() >= \
                self.deadline and not self.hold():
            raise StopIteration
        t0 = time.perf_counter()
        batch = next(self.source)
        if self.timing:
            self.loader_s.append(time.perf_counter() - t0)
        self.index[id(batch)] = self.n
        self.n += 1
        return batch


def cycle(batches):
    while True:
        yield from batches


def run(ctx) -> dict:
    from ws3d_tpu_torch.datasets.boxplace_dataset import BoxPlaceDataset
    from ws3d_tpu_torch.models.detector import PointRCNN
    from ws3d_tpu_torch.training.trainer import Trainer
    tr = ctx.traffic
    tree = ctx.cfg_tree
    cfg = harness.program_config(ctx.cell)
    device = torch.device(ctx.device) if ctx.device else torch.device(
        "cuda", 0)
    on_card = device.type == "cuda"
    B, pts = int(tr["batch"]), int(tr["points"])
    db = synthetic_proposal_database(num=int(tr["database"]),
                                     seed=sub_seed(ctx.seed, "db", SEED_MAX),
                                     crop_points=pts)
    loader_seed = sub_seed(ctx.seed, "loader", SEED_MAX)
    ds = BoxPlaceDataset(db, cfg, mode="TRAIN", npoints=pts,
                         seed=loader_seed, aug_copies=int(tr["aug_copies"]))
    source = ds.batches(B, shuffle=True)
    if int(tr["prebuilt"]):
        source = cycle([next(source) for _ in range(int(tr["prebuilt"]))])
    feed = Feed(source)

    from benchmark.reference.train import initial_weights
    model = PointRCNN(cfg).to(device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w_seed = sub_seed(ctx.seed, "weights", SEED_MAX)
    model.load_state_dict(initial_weights(shapes, w_seed, device))
    model.train()
    trainer = Trainer(model, cfg, int(tr["total_steps"]), stage="rcnn",
                      seed=sub_seed(ctx.seed, "dropout", SEED_MAX),
                      log_fn=lambda msg: print("# " + msg, file=sys.stderr))
    state = instrument(ctx, trainer, feed, int(tr["check_steps"]))
    n_check = int(tr["check_steps"])
    prefetch = int(tr["prefetch"])
    hist = trainer.train_steps(feed, n_check, log_every=1,
                               prefetch_size=prefetch)
    prog_losses = [h["loss"] for h in hist]
    trainer.train_steps(feed, int(tr["warmup"]), log_every=10**9,
                        prefetch_size=prefetch)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    print(f"# card {harness.card_note() if on_card else 'cpu'}; batch {B} "
          f"crops of {pts}, database {len(db)} x {tr['aug_copies']}, "
          f"prebuilt {tr['prebuilt']}", flush=True)

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
        trainer.train_steps(feed, 10**9, log_every=10**9,
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
        record.update({"kind": "train", "iters": n,
                       "host_s": dict(ctx.spans.host),
                       "calls": {k: list(v)
                                 for k, v in ctx.spans.calls.items()},
                       "loader_s": list(state["loader_s"]),
                       "flops": n * counts.trunk_flops(tree, B)})
    prog = {"losses": prog_losses, "first_grad": state["first_grad"],
            "params": state["params"],
            "batches": [{k: b[k] for k in CHECK_KEYS}
                        for b in state["batches"]],
            "numbers": [feed.index[id(b)] for b in state["batches"]]}
    del trainer, model, feed, state
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check_numbers(ctx, prog, db, loader_seed, w_seed, shapes,
                            device)
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


CHECK_KEYS = ("cur_box_point", "cur_box_reflect", "train_mask", "gt_boxes",
              "cls")


def instrument(ctx, trainer, feed, n_check: int) -> dict:
    """Wraps the Trainer's step for the check's snapshots and the traced
    stretch, its host-batch hand-over for the batches the check's steps
    consumed, the backward and the counted kernels for their spans."""
    import ws3d_tpu_torch.ops.fused_sa as fsa
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
                sp, state["record"], batch[CHECK_KEYS[0]].is_cuda))
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
    return state


def check_numbers(ctx, prog, db, loader_seed, w_seed, shapes,
                  device) -> dict:
    """The reference's loader batches and steps beside the program's."""
    from benchmark.reference.loader import BoxPlaceDataset
    from benchmark.reference.net import f32_matmuls
    from benchmark.reference.train import Tree, initial_weights, run_steps
    tr, tree = ctx.traffic, ctx.cfg_tree
    ds = BoxPlaceDataset(db, Tree(tree), mode="TRAIN",
                         npoints=int(tr["points"]), seed=loader_seed,
                         aug_copies=int(tr["aug_copies"]))
    it = ds.batches(int(tr["batch"]), shuffle=True)
    cyc = int(tr["prebuilt"]) or max(prog["numbers"]) + 1
    numbers = [n % cyc for n in prog["numbers"]]
    built = [next(it) for _ in range(max(numbers) + 1)]
    built = [built[n] for n in numbers]
    mismatch = sum(int(np.sum(np.asarray(b[k]) != np.asarray(p[k])))
                   + abs(np.asarray(b[k]).size - np.asarray(p[k]).size)
                   for b, p in zip(built, prog["batches"])
                   for k in CHECK_KEYS)
    batches = [{k: torch.from_numpy(np.ascontiguousarray(b[k])).to(device)
                for k in CHECK_KEYS} for b in built]
    params = initial_weights(shapes, w_seed, device)
    p0 = {k: v.clone() for k, v in params.items()}
    with f32_matmuls():
        ref = run_steps(params, tree, batches, int(tr["total_steps"]))
    return step_numbers(prog, ref, p0, mismatch)


def step_numbers(prog, ref, p0, mismatch) -> dict:
    from benchmark.reference import compare
    from benchmark.reference.train import norms
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(prog["losses"], ref["losses"])]
    g_ref = norms(ref["first_grad"])
    g_prog = norms(prog["first_grad"])
    med = float(np.median(list(g_ref.values())))
    moved = [k for k, v in g_ref.items() if v >= 1e-3 * med]
    c_ref = norms({k: ref["params"][k] - p0[k] for k in p0})
    c_prog = norms({k: prog["params"][k].to(p0[k].device) - p0[k]
                    for k in p0})
    out = {"batch_mismatch": float(mismatch), "loss1_gap": loss_gaps[0],
           "grad_gap": compare.leaf_gap(g_prog, g_ref),
           "grad_median_gap": compare.leaf_median_gap(g_prog, g_ref),
           "change_gap": compare.leaf_gap(c_prog, c_ref, moved)}
    print(f"# reference losses {ref['losses']}, program "
          f"{prog['losses']}; loss gaps {loss_gaps}; "
          f"{len(moved)}/{len(g_ref)} leaves moved",
          file=sys.stderr, flush=True)
    return out
