"""The readings that the limits of the stage-1 training cells' check of
outputs are set from, on the card at the cells' own size (the benchmark's
runs never run this).

    python3 benchmark/calibrate_rpn.py --workload <cell> --seeds a,b,...
        [--control-seeds x,y,...] [--fault bn_eval|half_batch]
        [--seconds s]

For each of --seeds: one whole run of the cell (set-up, a window of
--seconds, the check), printing the numbers the check compares; a seed
given twice reads how far the card's atomics move a sound run. With
--fault those runs have the program's step broken underneath (FAULTS).
For each of --control-seeds, the reference's own variants read against
the reference on the seed's first batches: TF32 matrix products (the
lower-precision control), half of each batch's scenes, and BatchNorm in
eval mode. A step that returns its state unchanged reads 1 on change_gap
by the measure's definition and needs no run. Each reading is one JSON
line on standard output.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.calibrate import emit  # noqa: E402


def _bn_eval(patch=setattr):
    """Every BatchNorm normalises with its running statistics, as in eval,
    and leaves them as they are. `patch` is setattr or a test's."""
    from ws3d_tpu_torch.models.layers import BatchNorm
    forward = BatchNorm.forward

    def eval_forward(self, x, train=False, momentum=0.1):
        return forward(self, x, False, momentum)
    patch(BatchNorm, "forward", eval_forward)


def _half_batch(patch=setattr):
    """The step sees the first half of each batch's scenes."""
    import ws3d_tpu_torch.training.trainer as trainer
    to_device = trainer.batch_to_device

    def half(batch, device, keys=trainer.RPN_INPUTS):
        return to_device({k: batch[k][:len(batch[k]) // 2] for k in keys},
                         device, keys)
    patch(trainer, "batch_to_device", half)


FAULTS = {"bn_eval": _bn_eval, "half_batch": _half_batch}


def control(cell: dict, seed: int, device) -> dict:
    import numpy as np
    import torch
    from benchmark import harness
    from benchmark.drivers.rpn_train_loop import SEED_MAX, scenes_of
    from benchmark.drivers.train_loop import step_numbers
    from benchmark.gen.scenes import sub_seed
    from benchmark.reference.net import f32_matmuls
    from benchmark.reference.rpn_loader import RPNTrainLoader
    from benchmark.reference.rpn_train import (INPUTS, rpn_initial_weights,
                                               run_steps, split)
    from ws3d_tpu_torch.models.detector import PointRCNN
    ctx = harness.Context(cell, seed, 0.0, False, 0.0)
    tr, tree = ctx.traffic, ctx.cfg_tree
    shapes = {k: tuple(v.shape) for k, v in PointRCNN(
        harness.program_config(cell)).state_dict().items()}
    loader = RPNTrainLoader(scenes_of(ctx), tree, int(tr["weakly_num"]),
                            sub_seed(seed, "loader", SEED_MAX))
    it = loader.batches(int(tr["batch"]))
    host = [next(it) for _ in range(int(tr["check_steps"]))]
    w_seed = sub_seed(seed, "weights", SEED_MAX)
    d_seed = sub_seed(seed, "dropout", SEED_MAX)

    def steps(tf32=False, rows=None, bn_train=True):
        batches = [{k: torch.from_numpy(np.ascontiguousarray(
            b[k][:rows])).to(device) for k in INPUTS} for b in host]
        state = rpn_initial_weights(shapes, w_seed, device)
        with f32_matmuls(tf32):
            return run_steps(state, tree, batches, int(tr["total_steps"]),
                             d_seed, bn_train=bn_train)
    p0 = split(rpn_initial_weights(shapes, w_seed, device))[0]
    ref = steps()
    return {"tf32": step_numbers(steps(tf32=True), ref, p0, 0),
            "half_batch": step_numbers(steps(rows=int(tr["batch"]) // 2),
                                       ref, p0, 0),
            "bn_eval": step_numbers(steps(bn_train=False), ref, p0, 0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    import torch
    from benchmark import harness
    cell = harness.load_cell(ROOT, args.workload)
    if harness.missing_device(cell["chips"]):
        print("calibrate_rpn: no CUDA card", file=sys.stderr)
        return 2
    harness.set_cache_dirs(ROOT)
    if args.fault:
        FAULTS[args.fault]()
    t = T_START
    for s in filter(None, args.seeds.split(",")):
        r = harness.run_cell(cell, seed=int(s), seconds=args.seconds,
                             trace=False, t_start=t)
        emit(args.fault or "program", int(s),
             {k: c["value"] for k, c in r["checks"].items()},
             {"correct": r["correct"], "metrics": {
                 k: m["value"] for k, m in r["metrics"].items()}})
        torch.cuda.empty_cache()
        t = time.perf_counter()
    for s in filter(None, args.control_seeds.split(",")):
        for kind, numbers in control(cell, int(s),
                                     torch.device("cuda", 0)).items():
            emit(kind, int(s), numbers)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
