"""The multi-rank parity dryrun: the port's twin of
__graft_entry__.dryrun_multichip.

    python -m ws3d_tpu_torch.parallel.dryrun 2            # gloo, CPU
    python -m ws3d_tpu_torch.parallel.dryrun 4 --device cuda   # NCCL, 4 GPUs

dryrun_multichip(n, device) starts n ranks (parallel.launch) and runs the
JAX dryrun's three suites at its shapes and bounds:

1. the stage-1 RPN train step at the tiny shapes (256 points, SA npoints
   64/32/16/8, DP_RATIO 0): exact parity with the single-process step when
   every rank gets the same shard (< 1e-5), bitwise determinism over two
   calls, the full batch's loss within 5 % of the single step's, and the
   replicas bit-equal;
2. the IOUN cascade step (8 crops of 64 points a rank, the fitted trunk,
   the seeded cascade): the same exact parity and replicas, the full
   batch's loss within 15 % (each rank normalises its masked means over
   its own 8 crops);
3. two-stage inference with the fitted npz at 2,048 points and 8 proposals
   on the EVAL loader's synthetic scenes, one a rank: live proposals, no
   spilled slot on either side, the packed records within 1e-3 of the
   single-process batch in f32 and within 0.1 with equal keep counts in
   bf16.

Rank 0 runs the single-process references on its own device.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "ws3d_tpu", "data", "bench_weights.npz")


def flagship_cfg(tiny: bool = False):
    """The two-stage config of the JAX dryrun (__graft_entry__._flagship_cfg):
    RCNN and IOUN on, bf16; `tiny` cuts the point counts and computes in
    f32 for the train steps."""
    from ws3d_tpu_torch.config import load_config
    cfg = load_config()
    cfg.RCNN.ENABLED = True
    cfg.IOUN.ENABLED = True
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    if tiny:
        cfg.TPU.COMPUTE_DTYPE = "float32"
        cfg.RPN.NUM_POINTS = 256
        cfg.RPN.SA_CONFIG.NPOINTS = [64, 32, 16, 8]
        cfg.RCNN.NUM_POINTS = 64
        cfg.RCNN.SA_CONFIG.NPOINTS = [32, 16, 8, -1]
        cfg.IOUN.SA_CONFIG.NPOINTS = [32, 16, 8, -1]
        cfg.TPU.MAX_PROPOSALS = 8
    return cfg


def cpu_state(model) -> dict:
    """A copy of the model's state dict on the CPU."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def max_diff(a: dict, b: dict) -> float:
    """Largest |a - b| over two state dicts (0.0: bitwise equal)."""
    if a.keys() != b.keys():
        raise KeyError("state dicts differ in keys")
    return max((float((a[k].double() - b[k].double()).abs().max())
                for k in a if a[k].numel()), default=0.0)


def one_step(cfg, stage: str, model, batch: dict, group=None):
    """One train step of `model` (AdamOneCycle from count 0, no dropout
    generator, BN momentum 0.1) on the step's inputs of `batch`: the
    single-process step, or with a group the data-parallel step on the
    rank's shard (the model broadcast from rank 0 first). Returns (the
    state after it on the CPU, its scalar aux values, the gradients the
    optimizer applied, again), where again() runs one more step on the
    same batch."""
    from ws3d_tpu_torch.parallel import data_parallel_step, replicate
    from ws3d_tpu_torch.training.optim import AdamOneCycle
    from ws3d_tpu_torch.training.trainer import (batch_to_device,
                                                 make_rcnn_train_step,
                                                 make_rpn_train_step,
                                                 step_inputs,
                                                 trainable_parameters)
    opt = AdamOneCycle(cfg, 1000, trainable_parameters(model, stage).items())
    applied, apply = {}, opt.step

    def record(grads):
        applied.update({k: g.detach().cpu().clone()
                        for k, g in grads.items()})
        apply(grads)
    opt.step = record
    step = (make_rpn_train_step(model, cfg, opt, group) if stage == "rpn"
            else make_rcnn_train_step(model, cfg, opt, stage, group))
    keys = step_inputs(stage, batch)
    if group is None:
        inputs = batch_to_device(batch, next(model.parameters()).device,
                                 keys)
    else:
        replicate(model, group)
        step = data_parallel_step(step, group)
        inputs = {k: batch[k] for k in keys}
    aux = step(inputs, None, 0.1)
    opt.step = apply
    return (cpu_state(model), {k: float(v) for k, v in aux.items()
                               if v.dim() == 0}, applied,
            lambda: step(inputs, None, 0.1))


def stage2_model(cfg, device):
    """The stage-2 model with the fitted npz's RCNN trunk and the seeded
    cascade (the fitted cascade's ReLUs are all off below SA1's last layer
    on synthetic crops, so it would train nothing)."""
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.training.trainer import CASCADE_PREFIXES
    from ws3d_tpu_torch.weights import load_flat, to_flat
    model = build_model(cfg, device=device, seed=0)
    flat = to_flat(model)
    with np.load(WEIGHTS) as z:
        flat.update({k: z[k] for k in z.files if k in flat and not
                     k.split("/")[2].startswith(CASCADE_PREFIXES)})
    load_flat(model, flat)
    return model


def _train_suite(group, stage: str, batch, per: int) -> dict:
    """Sharded steps on identical shards (the first `per` samples on every
    rank), on the full batch twice; rank 0 adds the single-process steps
    on the shard and on the full batch. Every step starts from the same
    weights: the seeded init for the RPN, stage2_model for the IOUN (the
    seeded stage-2 trunk makes single crops dominate the loss: 84,064 in
    one shard of 8 crops, ~1,000 in the others, at 4 ranks)."""
    from ws3d_tpu_torch.models import build_model
    cfg = _train_cfg(stage)

    def run(b, g=None):
        model = (build_model(cfg, device=group.device, seed=0)
                 if stage == "rpn" else stage2_model(cfg, group.device))
        state, aux, _, _ = one_step(cfg, stage, model, b, g)
        return state, aux["loss"]
    tiled = {k: np.concatenate([v[:per]] * group.world_size)
             for k, v in batch.items()}
    out = {"tiled": run(tiled, group)[0]}
    out["full"], out["loss"] = run(batch, group)
    out["full2"] = run(batch, group)[0]
    if group.is_main:
        out["ref_shard"] = run({k: v[:per] for k, v in batch.items()})[0]
        out["ref_loss"] = run(batch)[1]
    return out


def _train_cfg(stage: str):
    cfg = flagship_cfg(tiny=True)
    for tree in (cfg.RPN, cfg.RCNN, cfg.IOUN):
        tree.DP_RATIO = 0.0             # no dropout: exact parity
    if stage != "rpn":
        cfg.RPN.ENABLED = False
    return cfg


def _rpn_batch(n: int) -> dict:
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    cfg = _train_cfg("rpn")
    src = SyntheticKitti(num_scenes=n, points_per_scene=1200, seed=0)
    ds = RPNDataset(src, cfg, mode="TRAIN", npoints=cfg.RPN.NUM_POINTS)
    # shuffled, as the JAX dryrun's batch (its loader's default)
    return next(ds.batches(batch_size=n, steps=1, shuffle=True))


def _ioun_batch(n: int) -> dict:
    from ws3d_tpu_torch.datasets import (BoxPlaceDataset,
                                         synthetic_proposal_database)
    cfg = _train_cfg("ioun")
    db = synthetic_proposal_database(num=8 * n, seed=0,
                                     crop_points=cfg.RCNN.NUM_POINTS)
    ds = BoxPlaceDataset(db, cfg, mode="TRAIN", npoints=cfg.RCNN.NUM_POINTS,
                         seed=0)
    return next(ds.batches(8 * n))


def _infer_suite(group) -> dict:
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.parallel import data_parallel_infer
    from ws3d_tpu_torch.pipeline import make_two_stage_fn
    from ws3d_tpu_torch.weights import load_npz

    n = group.world_size
    cfg = flagship_cfg()
    cfg.RPN.NUM_POINTS = 2048
    cfg.RPN.SA_CONFIG.NPOINTS = [512, 128, 32, 8]
    cfg.TPU.MAX_PROPOSALS = 8
    src = SyntheticKitti(num_scenes=n, points_per_scene=4096, seed=0)
    ds = RPNDataset(src, cfg, mode="EVAL", seed=0)
    pts = torch.from_numpy(np.stack([ds.get_sample(i)["pts_input"]
                                     for i in range(n)]))
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg.TPU.COMPUTE_DTYPE = dtype
        model = build_model(cfg, device=group.device, seed=0)
        load_npz(model, WEIGHTS)
        got = data_parallel_infer(make_two_stage_fn(model, cfg, group=group),
                                  group)(pts)
        res = {"packed": got["packed"].cpu(), "spilled": int(got["spilled"]),
               "n_live": int(got["n_live"])}
        if group.is_main:
            ref = make_two_stage_fn(model, cfg)(pts.to(group.device))
            res.update(ref_packed=ref["packed"].cpu(),
                       ref_spilled=int(ref["spilled"]),
                       ref_n_live=int(ref["n_live"]),
                       ref_keep=int(ref["keep"].sum()))
        out[dtype] = res
    return out


def _suites(group) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    n = group.world_size
    return {"rpn": _train_suite(group, "rpn", _rpn_batch(n), 1),
            "ioun": _train_suite(group, "ioun", _ioun_batch(n), 8),
            "infer": _infer_suite(group)}


def _check_train(n: int, name: str, ranks: list, bound: float) -> str:
    main = ranks[0]
    exact = max_diff(main["tiled"], main["ref_shard"])
    if not exact < 1e-5:
        raise AssertionError(f"{name} sharded != single on identical "
                             f"shards: {exact}")
    det = max_diff(main["full"], main["full2"])
    if det != 0.0:
        raise AssertionError(f"sharded {name} step nondeterministic: {det}")
    for r, res in enumerate(ranks[1:], 1):
        for key in ("tiled", "full"):
            if max_diff(main[key], res[key]) != 0.0:
                raise AssertionError(f"{name}: rank {r}'s replica differs "
                                     f"from rank 0's ({key})")
    loss, ref = main["loss"], main["ref_loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite {name} loss: {loss}")
    err = abs(loss - ref) / max(abs(ref), 1e-8)
    if not err < bound:
        raise AssertionError(f"{name} sharded loss diverges from the full "
                             f"batch: {err}")
    return (f"dryrun_multichip({n}) {name} train: loss={loss:.4f} "
            f"exact_parity={exact:.2e} deterministic, replicas equal, vs "
            f"full-batch rel_loss={err:.2e} OK")


def _check_infer(n: int, ranks: list) -> list:
    lines = []
    for dtype, bound in (("float32", 1e-3), ("bfloat16", 0.1)):
        main = ranks[0][dtype]
        if main["ref_n_live"] <= 0:
            raise AssertionError("no live proposals: the kernels ran on "
                                 "nothing")
        spilled = [main["ref_spilled"], main["spilled"]]
        if any(spilled) or main["n_live"] != main["ref_n_live"]:
            raise AssertionError(f"{dtype}: stage-2 slots spilled "
                                 f"{spilled} (parity needs none), live "
                                 f"{main['n_live']} vs {main['ref_n_live']}")
        a, b = main["ref_packed"].float(), main["packed"].float()
        if a.shape != b.shape:
            raise AssertionError(f"packed {tuple(a.shape)} vs "
                                 f"{tuple(b.shape)}")
        err = float((a - b).abs().max())
        if not err < bound:
            raise AssertionError(f"sharded {dtype} two-stage diverges: max "
                                 f"abs {err}")
        keeps_a, keeps_b = (a[..., 8] > 0.5).sum(-1), (b[..., 8] > 0.5).sum(-1)
        if not torch.equal(keeps_a, keeps_b):
            raise AssertionError(f"{dtype} keep counts {keeps_a.tolist()} "
                                 f"vs {keeps_b.tolist()}")
        for r, res in enumerate(ranks[1:], 1):
            if not torch.equal(res[dtype]["packed"], main["packed"]):
                raise AssertionError(f"rank {r} gathered another record")
        lines.append(f"dryrun_multichip({n}) two-stage inference {dtype}: "
                     f"{main['ref_n_live']} live proposals, "
                     f"{main['ref_keep']} detections, sharded "
                     f"max|diff|={err:.2e}, keep counts matched, spilled 0 OK")
    return lines


def dryrun_multichip(n_devices: int, device="cpu", timeout: float = 1800.0,
                     log=print) -> None:
    """Run the three suites on `n_devices` ranks (gloo on the CPU; NCCL,
    one card a rank, for device="cuda") and raise AssertionError unless
    every bound holds."""
    from ws3d_tpu_torch.parallel import launch
    ranks = launch(_suites, n_devices, device=device, timeout=timeout)
    log(_check_train(n_devices, "rpn", [r["rpn"] for r in ranks], 5e-2))
    log(_check_train(n_devices, "ioun", [r["ioun"] for r in ranks], 0.15))
    for line in _check_infer(n_devices, [r["infer"] for r in ranks]):
        log(line)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default="cpu",
                   help="cpu (gloo ranks) or cuda (NCCL, one card a rank)")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
