"""The readings that the limits of a cell's check of outputs are set from,
on the card at the cell's own size (the benchmark's runs never run this).

    python3 benchmark/calibrate.py --workload <cell> --seeds a,b,...
        --seconds <s> [--control-seeds x,y,...]

For each of --seeds: one whole run of the cell (set-up, a window of
--seconds, the check), printing the numbers the check compares. For each
of --control-seeds, the lower-precision control put in the program's
place and read against the same reference:
- inference: the reference with every dense product's factors rounded to
  float8 e4m3 (one scale a tensor), on the checked batches of the seed's
  scenes;
- training: the reference's steps with TF32 matrix products, on the seed's
  first batches; and the fault "half of the batch left out, the mean taken
  over the rest" (the steps on the first half of each batch's rows). A
  step that returns its state unchanged reads 1 on change_gap by the
  measure's definition and needs no run.
With --fault <name> the program runs of --seeds run with the timed path
broken underneath (FAULTS below), for the upper reading of the number
that the fault has to fail.
Each reading is one JSON line on standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def emit(kind: str, seed: int, numbers: dict, extra=None) -> None:
    print(json.dumps({"kind": kind, "seed": seed, "numbers": numbers,
                      **(extra or {})}), flush=True)


def _broken_packed(edit):
    """make_two_stage_fn -> the same with edit(packed, first scene index)
    applied to each call's packed record (its keep column is what the txt
    files hold)."""
    def wrap(make):
        def made(model, cfg, *a, **kw):
            fn = make(model, cfg, *a, **kw)
            seen = [0]

            def broken(pts):
                out = fn(pts)
                packed = out["packed"].clone()
                edit(packed, seen[0])
                seen[0] += pts.shape[0]
                return dict(out, packed=packed, keep=packed[..., 8] > 0.5)
            return broken
        return made
    return wrap


def _drop_half(packed, first: int) -> None:
    """Every second scene of the run's stream keeps no detection: stage 2
    leaves out half of the batch (at batch 1, every second batch)."""
    import torch
    idx = torch.arange(first, first + packed.shape[0],
                       device=packed.device)
    packed[idx % 2 == 1, :, 8] = 0.0


def _top_box_only(packed, first: int) -> None:
    """Each scene keeps only its best-scored detection."""
    keep = packed[..., 8] > 0.5
    score = packed[..., 7].masked_fill(~keep, float("-inf"))
    best = score.argmax(dim=1, keepdim=True)
    one = keep.gather(1, best)
    packed[..., 8] = 0.0
    packed[..., 8].scatter_(1, best, one.to(packed.dtype))


FAULTS = {"stage2_half": _broken_packed(_drop_half),
          "top_box_only": _broken_packed(_top_box_only)}


def inference_control(cell: dict, seed: int, device) -> dict:
    import numpy as np
    from benchmark.drivers import infer_loop
    from benchmark.gen.scenes import scene_batches, sub_seed
    from benchmark.reference.net import Net, fp8, load_npz
    tr, tree = cell["traffic_file"], cell["config_file"]["config"]
    B, nbuf = int(tr["batch"]), int(tr["n_batches"])
    bufs = scene_batches(seed, B, nbuf, int(tree["RPN"]["NUM_POINTS"]),
                         int(tr["points_per_scene"]), int(tr["max_cars"]),
                         tree["PC_AREA_SCOPE"])
    rng = np.random.RandomState(sub_seed(seed, "check", 2**31 - 1))
    checked = sorted(rng.choice(nbuf, min(int(tr["check_batches"]), nbuf),
                                replace=False).tolist())
    weights = os.path.join(ROOT, cell["config_file"]["weights"])
    params = load_npz(weights, device)
    ref = infer_loop.reference_side(Net(params, tree), tree, device, bufs,
                                    checked)
    low = infer_loop.reference_side(Net(params, tree, fp8), tree, device,
                                    bufs, checked)
    return {"fp8": infer_loop.numbers(low, ref, checked)}


def training_control(cell: dict, seed: int, device) -> dict:
    import numpy as np
    import torch
    from benchmark.drivers.train_loop import (CHECK_KEYS, SEED_MAX,
                                              step_numbers)
    from benchmark.gen.proposals import synthetic_proposal_database
    from benchmark.gen.scenes import sub_seed
    from benchmark.reference.loader import BoxPlaceDataset
    from benchmark.reference.net import f32_matmuls
    from benchmark.reference.train import Tree, initial_weights, run_steps
    from ws3d_tpu_torch.models.detector import PointRCNN
    from ws3d_tpu_torch.config import load_config
    tr, tree = cell["traffic_file"], cell["config_file"]["config"]
    cfg = load_config().merge(tree, strict=True)
    shapes = {k: tuple(v.shape) for k, v in PointRCNN(cfg).state_dict()
              .items()}
    db = synthetic_proposal_database(num=int(tr["database"]),
                                     seed=sub_seed(seed, "db", SEED_MAX),
                                     crop_points=int(tr["points"]))
    ds = BoxPlaceDataset(db, Tree(tree), mode="TRAIN",
                         npoints=int(tr["points"]),
                         seed=sub_seed(seed, "loader", SEED_MAX),
                         aug_copies=int(tr["aug_copies"]))
    it = ds.batches(int(tr["batch"]), shuffle=True)
    host = [next(it) for _ in range(int(tr["check_steps"]))]
    w_seed = sub_seed(seed, "weights", SEED_MAX)

    def steps(tf32=False, rows=None):
        batches = [{k: torch.from_numpy(np.ascontiguousarray(
            b[k][:rows])).to(device) for k in CHECK_KEYS} for b in host]
        params = initial_weights(shapes, w_seed, device)
        with f32_matmuls(tf32):
            return run_steps(params, tree, batches, int(tr["total_steps"]))
    p0 = initial_weights(shapes, w_seed, device)
    ref = steps()
    half = int(tr["batch"]) // 2
    return {"tf32": step_numbers(steps(tf32=True), ref, p0, 0),
            "half_batch": step_numbers(steps(rows=half), ref, p0, 0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    import torch
    from benchmark import harness
    cell = harness.load_cell(ROOT, args.workload)
    if harness.missing_device(cell["chips"]):
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    harness.set_cache_dirs(ROOT)
    if args.fault:
        import ws3d_tpu_torch.pipeline as pipeline
        pipeline.make_two_stage_fn = FAULTS[args.fault](
            pipeline.make_two_stage_fn)
    t = T_START
    for s in filter(None, args.seeds.split(",")):
        r = harness.run_cell(cell, seed=int(s), seconds=args.seconds,
                             trace=False, t_start=t)
        emit(args.fault or "program", int(s), {k: c["value"] for k, c in
                                 r["checks"].items()},
             {"correct": r["correct"], "metrics": {
                 k: m["value"] for k, m in r["metrics"].items()}})
        torch.cuda.empty_cache()
        t = time.perf_counter()
    control = (training_control if cell["traffic_file"]["driver"]
               == "train_loop" else inference_control)
    for s in filter(None, args.control_seeds.split(",")):
        for kind, numbers in control(cell, int(s),
                                     torch.device("cuda", 0)).items():
            emit(kind, int(s), numbers)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
