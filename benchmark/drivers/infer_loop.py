"""Two-stage inference in a closed loop, one batch in flight, the KITTI
txt files written on a writer thread (the loop of the port's tools/bench.py,
kept here): each batch's packed record is copied into pinned host memory
behind the queued work, an event marks the copy's end, and the writer
waits on it and writes the batch's files while the next batch runs.

Set-up: the model on the card with the fitted weights, make_two_stage_fn,
`n_batches` distinct batches of `batch` scenes drawn from the seed and
moved to the card, and `warmup` batches each read back. The window then
cycles through the batches for --seconds. scenes_per_s is the scenes
written over the time from the first dispatch to the last file, scene_ms
its inverse in ms a scene. The 95th percentile of the batches' times,
each from its dispatch to its last txt file written, is printed on an
earlier line.

The check of outputs: `check_batches` of the distinct batches, drawn from
the seed; for each, the last run of it in the window is held against the
plain reference on the same scenes (benchmark/reference/compare.py).
"""
from __future__ import annotations

import json
import os
import queue
import sys
import tempfile
import threading
import time
from contextlib import ExitStack

import numpy as np
import torch

from benchmark import harness, trace
from benchmark.gen.scenes import scene_batches, sub_seed
from benchmark.roofline import counts

IMAGE_SHAPE = (375, 1242)


class Writer(threading.Thread):
    """Writes each batch's KITTI txt files once its host copy has landed,
    and records when the batch's last file was written and how long the
    writing took. finish() waits for the queued batches and re-raises the
    first error."""

    def __init__(self, batch: int, out_dir: str):
        super().__init__(name="kitti-writer", daemon=True)
        from ws3d_tpu_torch.datasets.kitti_io import Calibration
        self.batch, self.out_dir = batch, out_dir
        self.calib = Calibration.identity()
        self.jobs: queue.Queue = queue.Queue()
        self.error = None
        self.done = {}            # it -> (perf_counter at the end, seconds)

    def run(self):
        while (job := self.jobs.get()) is not None:
            if self.error is None:
                try:
                    self._write(*job)
                except Exception as e:       # re-raised by finish()
                    self.error = e

    def _write(self, it: int, host: torch.Tensor, done) -> None:
        from ws3d_tpu_torch.datasets.kitti_io import save_kitti_format
        if done is not None:
            done.synchronize()
        t0 = time.perf_counter()
        packed = host.numpy()
        boxes, scores = packed[..., 0:7], packed[..., 7]
        keep = packed[..., 8] > 0.5
        for j in range(self.batch):
            save_kitti_format(it * self.batch + j, self.calib,
                              boxes[j][keep[j]], self.out_dir,
                              scores[j][keep[j]], IMAGE_SHAPE)
        t1 = time.perf_counter()
        self.done[it] = (t1, t1 - t0)

    def finish(self) -> None:
        self.jobs.put(None)
        self.join()
        if self.error is not None:
            raise self.error


def to_host(packed: torch.Tensor):
    """(host copy, event or None)."""
    if not packed.is_cuda:
        return packed.clone(), None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def instrument(ctx, model) -> None:
    """Spans around the calls into each layer (recorded only while a
    stretch is traced): the stage-1 net, the proposal layer and finalize
    (the glue), the trunk and the cascade, and the counted kernels."""
    import ws3d_tpu_torch.ops.fused_sa as fsa
    import ws3d_tpu_torch.ops.sampling as smp
    import ws3d_tpu_torch.pipeline.inference as inf
    sp = ctx.spans
    model.rpn_forward = sp.wrap("stage1_net", model.rpn_forward)
    model.rcnn_trunk_forward = sp.wrap(
        "stage2_trunk", model.rcnn_trunk_forward,
        lambda b: b["cur_box_point"].shape[0])
    model.ioun_forward = sp.wrap(
        "stage2_cascade", model.ioun_forward,
        lambda b: b["cur_box_point"].shape[0])
    inf.rpn_propose = sp.wrap("propose", inf.rpn_propose)
    inf.finalize_detections = sp.wrap("finalize", inf.finalize_detections)
    wrap_kernels(sp, fsa, smp)


def wrap_kernels(sp, fsa, smp) -> None:
    """Spans with shape notes around the fused-SA and FPS wrappers (looked
    up as module globals at each call)."""
    def sa_note(xyz, features, new_xyz, radius, nsample, kernels, biases,
                window, params=None, bf16=False, round_layers=False):
        return {"B": xyz.shape[0], "P": xyz.shape[1],
                "C": features.shape[-1], "M": new_xyz.shape[1],
                "S": int(nsample), "bf16": bool(bf16),
                "widths": [features.shape[-1] + 3]
                + [int(k.shape[1]) for k in kernels]}
    fsa.fused_sa_cuda = sp.wrap("fused_sa", fsa.fused_sa_cuda, sa_note)
    smp.fps_cuda = sp.wrap("fps", smp.fps_cuda, lambda xyz, npoint: {
        "R": xyz.shape[0], "N": xyz.shape[1], "npoint": int(npoint)})


def run(ctx) -> dict:
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    from ws3d_tpu_torch.weights import load_npz
    tr = ctx.traffic
    cfg = harness.program_config(ctx.cell)
    device = torch.device(ctx.device) if ctx.device else torch.device(
        "cuda", 0)
    on_card = device.type == "cuda"
    weights = os.path.join(harness.BENCH_DIR, os.pardir,
                           ctx.cell["config_file"]["weights"])
    model = build_model(cfg, device=device)
    n_w = load_npz(model, weights)
    instrument(ctx, model)
    fn = make_two_stage_fn(model, cfg)
    B, nbuf = int(tr["batch"]), int(tr["n_batches"])
    host_bufs = scene_batches(ctx.seed, B, nbuf, int(cfg.RPN.NUM_POINTS),
                              int(tr["points_per_scene"]),
                              int(tr["max_cars"]), cfg.PC_AREA_SCOPE)
    bufs = [torch.from_numpy(b).to(device) for b in host_bufs]
    for i in range(int(tr["warmup"])):
        fn(bufs[i % nbuf])["keep"].cpu()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    print(f"# card {harness.card_note() if on_card else 'cpu'}; weights "
          f"{n_w} tensors; batch {B}, {nbuf} distinct",
          flush=True)

    kept, dispatched, record = {}, {}, {}
    tmp = tempfile.TemporaryDirectory(prefix="ws3d_bench_")
    writer = Writer(B, tmp.name)
    writer.start()
    t_first = time.perf_counter()
    setup_s = t_first - ctx.t_start
    t_end = t_first + ctx.seconds
    t_start_trace = int(tr.get("trace_start", 2))
    n_trace = int(tr.get("trace_iters", 3))
    traced = []
    it = 0
    stack = ExitStack()
    try:
        # a traced run goes on until its traced stretch is whole
        while time.perf_counter() < t_end or (
                ctx.trace and it < t_start_trace + n_trace):
            if ctx.trace and it == t_start_trace:
                stack.enter_context(trace.profiled(ctx.spans, record,
                                                   on_card))
            dispatched[it] = time.perf_counter()
            out = fn(bufs[it % nbuf])
            writer.jobs.put((it,) + to_host(out["packed"]))
            kept[it % nbuf] = {"it": it, **{k: out[k] for k in (
                    "centers", "proposal_valid", "n_live", "spilled")}}
            if ctx.trace and t_start_trace <= it < t_start_trace + n_trace:
                traced.append(it)
                if it == t_start_trace + n_trace - 1:
                    stack.close()
            it += 1
        stack.close()
    finally:
        writer.finish()
    seconds = max(t for t, _ in writer.done.values()) - t_first
    lat = [(writer.done[i][0] - dispatched[i]) * 1e3 for i in range(it)]
    scenes = B * it
    written = sum(os.path.exists(os.path.join(tmp.name, "%06d.txt" % s))
                  for s in range(scenes))
    # the checked batches: drawn from the seed among those the window ran
    rng = np.random.RandomState(sub_seed(ctx.seed, "check", 2**31 - 1))
    ran = sorted(kept)
    checked = sorted(rng.choice(ran, min(int(tr["check_batches"]),
                                         len(ran)), replace=False).tolist())
    kept = {b: kept[b] for b in checked}
    dev = harness.device_fields(device, record if ctx.trace else None)
    if ctx.trace:
        record.update(layer_record(ctx, traced, writer, cfg, B))
    prog = {b: {"rows": [read_rows(tmp.name, k["it"] * B + j)
                         for j in range(B)],
                **{n: k[n].cpu().numpy() for n in
                   ("centers", "proposal_valid", "n_live", "spilled")}}
            for b, k in kept.items()}
    tmp.cleanup()
    del fn, model, bufs, kept
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check_numbers(ctx.cell["config_file"]["config"], weights,
                            device, host_bufs, checked, prog)
    print(f"# the check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr, flush=True)
    from benchmark.reference.compare import verdict
    checked_out = verdict(numbers, tr["limits"])
    print(f"# {it} batches, {written}/{scenes} scene files, batch p95 "
          f"{harness.percentile(lat, 95):.3f} ms, max spilled "
          f"{max(int(p['spilled']) for p in prog.values())}, live "
          f"{[int(p['n_live']) for p in prog.values()][:4]}, checked "
          f"{checked}; peak "
          f"{dev['memory_peak_bytes'] / 2**30:.2f} GiB", flush=True)
    return {"attempted": scenes, "failed": scenes - written,
            "end_to_end": {"scenes_per_s": written / seconds,
                           "scene_ms": seconds * 1e3 / max(written, 1),
                           "setup_s": setup_s},
            "device": dev, "record": record, **checked_out}


def read_rows(out_dir: str, sample: int) -> np.ndarray:
    from benchmark.reference.compare import read_kitti_txt
    return read_kitti_txt(os.path.join(out_dir, "%06d.txt" % sample))


def layer_record(ctx, traced, writer, cfg, B) -> dict:
    """Counts of the traced stretch for the metric readers."""
    sp = ctx.spans
    tree = ctx.cell["config_file"]["config"]
    n = max(len(traced), 1)
    dumps = [writer.done[i][1] for i in traced if i in writer.done]
    flops = counts.rpn_flops(tree, B * len(traced))
    flops += sum(counts.trunk_flops(tree, c)
                 for c in sp.calls.get("stage2_trunk", []))
    flops += sum(counts.cascade_flops(tree, c)
                 for c in sp.calls.get("stage2_cascade", []))
    return {"kind": "infer", "iters": n, "host_s": dict(sp.host),
            "calls": {k: list(v) for k, v in sp.calls.items()},
            "dump_s": dumps, "flops": flops,
            "bf16": str(cfg.TPU.COMPUTE_DTYPE) == "bfloat16"}


def check_numbers(tree, weights, device, host_bufs, checked, prog) -> dict:
    """The numbers of benchmark/reference/compare.py for the checked
    batches, pooled, against the float32 reference."""
    from benchmark.reference.net import Net, load_npz
    ref = reference_side(Net(load_npz(weights, device), tree), tree, device,
                         host_bufs, checked)
    return numbers(prog, ref, checked)


def reference_side(net, tree, device, host_bufs, checked) -> dict:
    """The plain reference's outputs for the checked batches, in the form
    the run keeps the program's: the rows of each scene's txt file,
    centres, proposal validity, n_live and spilled."""
    from benchmark.reference.net import f32_matmuls
    from benchmark.reference.pipeline import kitti_rows, two_stage
    out = {}
    with f32_matmuls():
        for b in checked:
            r = two_stage(net, tree, torch.from_numpy(host_bufs[b]).to(
                device))
            r = {k: v.cpu().numpy() for k, v in r.items()}
            out[b] = {"rows": [kitti_rows(r["boxes"][j], r["scores"][j],
                                          r["keep"][j], IMAGE_SHAPE)
                               for j in range(r["boxes"].shape[0])],
                      **{k: r[k] for k in ("centers", "proposal_valid",
                                           "n_live", "spilled")}}
    return out


def numbers(prog: dict, ref: dict, checked) -> dict:
    """Detections, proposals and live slots of the checked batches,
    pooled."""
    from benchmark.reference import compare
    out = compare.detection_numbers(
        [r for b in checked for r in ref[b]["rows"]],
        [r for b in checked for r in prog[b]["rows"]])
    out.update(compare.proposal_numbers(*(
        np.concatenate([side[b][k] for b in checked])
        for side in (ref, prog) for k in ("centers", "proposal_valid"))))
    live = [sum(int(side[b]["n_live"]) for b in checked)
            for side in (prog, ref)]
    out["live_gap"] = compare.count_gap(*live)
    n_det = [sum(len(r) for b in checked for r in side[b]["rows"])
             for side in (ref, prog)]
    spilled = [sum(int(side[b]["spilled"]) for b in checked)
               for side in (prog, ref)]
    print(f"# reference: {n_det[0]} detections, program {n_det[1]}; live "
          f"{live}, spilled {spilled}", file=sys.stderr, flush=True)
    print("# numbers " + json.dumps(out), file=sys.stderr, flush=True)
    return out
