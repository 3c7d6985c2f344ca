"""One-off readings on a CUDA card behind three gates of chip_smoke.py.

    python3 chip_gaps.py

Needs one CUDA card and a checkout of the repository; exits 2 otherwise.
It gates nothing and prints one line a reading. chip_smoke.py holds the
gates; the readings say why each gate stands where it does.

1. The global-batch stage-1 step (chip_smoke phase 22). The single
   16-scene step of phase 22 (the fitted stage-1 weights, DP_RATIO 0,
   deterministic algorithms) is run again with every BatchNorm's batch
   sums taken in other orders: unsplit two-pass (one sum for the mean,
   one of the squared deviations), split in halves as two ranks split them
   (chip_smoke._split_bn_sums), the halves added the other way round, and
   split in quarters. For each, the worst and median gradient gap to the
   single step, each a tensor's max|diff| over its max. Then the BatchNorm
   outputs of the single and the halves step, compared: how many change
   sign (the ReLU after them passes one and stops the other) and how far
   the outputs drift.
2. IOUN's bf16 step, card against CPU (chip_smoke phase 23's small
   batch). On four draws of 8 crops (crops 8d to 8d + 7 of phase 23's
   first IOUN batch), one bf16 step on the card (the kernels), one on the
   card with the fused SA's plain version in place of kernels 2 and 3
   (every other op is the same on both, FPS and the ball query are exact),
   one on the CPU (the plain versions) and one f32 step on the CPU; the
   median gradient gap of each pair, then the CPU's bf16 step with every
   bf16 product's f32 sum taken in another order (halves, quarters,
   chunks of 8, reversed) against the CPU's step. On draw 0 also both
   cascades started from the CPU trunk's boxes (one frame).
3. The BN-free SA stacks' bf16 eval mode (chip_smoke phase 17).
   eval_auto on phase 17's 16 scenes in f32, in bf16 (the package's
   rounded-layer mode for those stacks) and in bf16 with those stacks in
   the fused SA's bf16 mode (f32 bias and layers), each bf16 run's
   detections diffed against f32 by tools.diff_detections.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

import chip_smoke as cs

IOUN_DRAWS = 4
DRAW_CROPS = 8
SUM_ORDERS = ("halves", "quarters", "k8", "reversed")


# ------------------------------------------------------------------ 1.
@contextlib.contextmanager
def _bn_outputs(out: list):
    """Appends each train-mode BatchNorm output (detached) to `out`: the
    composition's, or on the fused path (ops.batchnorm.bn_relu_train) the
    same bits before its ReLU, recomputed from its arguments."""
    from ws3d_tpu_torch.models import layers
    from ws3d_tpu_torch.ops import batchnorm
    saved = layers.BatchNorm.forward
    saved_fused = batchnorm.bn_relu_train

    def forward(self, x, train=False, momentum=0.1):
        y = saved(self, x, train, momentum)
        if train:
            out.append(y.detach().clone())
        return y

    def fused(x, mean, inv, scale, bias):
        out.append(((x - mean) * inv * scale + bias).detach())
        return saved_fused(x, mean, inv, scale, bias)
    layers.BatchNorm.forward = forward
    batchnorm.bn_relu_train = fused
    try:
        yield
    finally:
        layers.BatchNorm.forward = saved
        batchnorm.bn_relu_train = saved_fused


def global_step_orders(card) -> None:
    import torch
    from ws3d_tpu_torch.config import load_config
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.parallel.dryrun import one_step

    t0 = time.perf_counter()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    src = SyntheticKitti(num_scenes=cs.BATCH * 2, points_per_scene=20000,
                         seed=3)
    host = list(RPNDataset(src, load_config(), mode="TRAIN", seed=0).batches(
        cs.BATCH, steps=1 + cs.SCALEOUT_STEPS, shuffle=True))[0]
    rpn_host = {k: host[k] for k in ("pts_input", "rpn_cls_label",
                                     "rpn_reg_label")}

    def step(ctx, outs=None):
        with cs._deterministic(), ctx, (_bn_outputs(outs) if outs is not None
                                        else contextlib.nullcontext()):
            cfg, model = cs._shared_card_models("rpn", "cuda")
            grads = one_step(cfg, "rpn", model, rpn_host, None)[2]
        del model
        torch.cuda.empty_cache()
        return grads
    single_out, split_out = [], []
    single = step(contextlib.nullcontext(), single_out)
    orders = {"two-pass": cs._split_bn_sums(1),
              "halves": cs._split_bn_sums(2),
              "halves reversed": cs._split_bn_sums(2, reverse=True),
              "quarters": cs._split_bn_sums(4)}
    for name, ctx in orders.items():
        grads = step(ctx, split_out if name == "halves" else None)
        worst, gap, median = cs._grad_gaps(grads, single)
        print(f"# 1: {card}: the single 16-scene stage-1 step with its BN "
              f"sums {name}: gradients within {gap:.4g} ({worst}), median "
              f"{median:.4g}", flush=True)
    flips, total, drift, near = 0, 0, 0.0, 0.0
    layers_flipped = []
    for i, (a, b) in enumerate(zip(single_out, split_out)):
        changed = (a > 0) != (b > 0)
        n = int(changed.sum())
        flips += n
        total += a.numel()
        drift = max(drift, float((a - b).abs().max()))
        if n:
            layers_flipped.append(i)
            near = max(near, float(a[changed].abs().max()))
    print(f"# 1: {card}: BN outputs of the single step against the halves "
          f"step: {flips} of {total} change sign, in {len(layers_flipped)} "
          f"of {len(single_out)} BatchNorms ({layers_flipped}); each within "
          f"{near:.3g} of zero; the outputs drift by at most {drift:.3g} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


# ------------------------------------------------------------------ 2.
@contextlib.contextmanager
def _reordered_bf16_sums(order: str):
    """Every bf16 product's f32 sum taken in another order, the products
    the same exact ones as fused_sa_idx.matmul_bf16's (which the dense
    layers and the plain fused SA use): over the reversed reduction axis,
    or over its halves, its quarters or its chunks of 8 (a tensor-core k
    step), the partial sums added in turn."""
    import torch
    from ws3d_tpu_torch.ops import fused_sa_idx

    def matmul_bf16(a, b):
        a, b = a.to(torch.bfloat16).float(), b.to(torch.bfloat16).float()
        K = b.shape[0]
        if order == "reversed":
            return torch.matmul(a.flip(-1), b.flip(0))
        size = {"halves": -(-K // 2), "quarters": -(-K // 4), "k8": 8}[order]
        out = torch.matmul(a[..., :size], b[:size])
        for lo in range(size, K, size):
            out = out + torch.matmul(a[..., lo:lo + size], b[lo:lo + size])
        return out
    saved = fused_sa_idx.matmul_bf16
    fused_sa_idx.matmul_bf16 = matmul_bf16
    try:
        yield
    finally:
        fused_sa_idx.matmul_bf16 = saved


@contextlib.contextmanager
def _plain_fused_sa():
    """Kernels 2 and 3 replaced by the fused SA's plain version on CUDA
    tensors (the same arguments, the plain version on the card)."""
    from ws3d_tpu_torch.ops import fused_sa
    saved = fused_sa.fused_sa_cuda

    def plain(xyz, features, new_xyz, radius, nsample, kernels, biases,
              window, params=None, bf16=False, round_layers=False):
        return fused_sa.fused_sa_plain(xyz, features, new_xyz, radius,
                                       nsample, kernels, biases, bf16,
                                       round_layers)
    fused_sa.fused_sa_cuda = plain
    try:
        yield
    finally:
        fused_sa.fused_sa_cuda = saved


def _ioun_step(host_batch, dtype: str, device: str, frame=None) -> dict:
    """The f32 gradients on the CPU of one IOUN step in `dtype` on
    `device`, no dropout; with `frame` the cascade starts from those trunk
    boxes instead of its own trunk's."""
    import torch
    from ws3d_tpu_torch.training.trainer import (batch_to_device,
                                                 rcnn_gradients, step_inputs,
                                                 trainable_parameters)
    cfg = cs._stage2_cfg("ioun")
    cfg.TPU.COMPUTE_DTYPE = dtype
    m = cs._stage2_model(cfg, device)
    if frame is not None:
        trunk = m.rcnn.trunk
        m.rcnn.trunk = lambda *a, **kw: {**trunk(*a, **kw),
                                         "pred_boxes3d": frame.to(device)}
    _, _, grads = rcnn_gradients(
        m, cfg, "ioun", batch_to_device(host_batch, device,
                                        step_inputs("ioun", host_batch)),
        None, 0.1, trainable_parameters(m, "ioun"))
    if {g.dtype for g in grads.values()} != {torch.float32}:
        raise AssertionError("IOUN gradients not all f32")
    return {k: g.cpu() for k, g in grads.items()}


def _cpu_trunk_boxes(host_batch):
    """The frozen trunk's boxes of an IOUN step's crops on the CPU (the
    plain bf16 versions, train mode): the cascade's frame."""
    import torch
    from ws3d_tpu_torch.training.trainer import batch_to_device, step_inputs
    cfg = cs._stage2_cfg("ioun")
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    m = cs._stage2_model(cfg, "cpu")
    b = batch_to_device(host_batch, "cpu", step_inputs("ioun", host_batch))
    with torch.no_grad():
        return m.rcnn.trunk(b["cur_box_point"], b["cur_box_reflect"],
                            b["train_mask"], train=True)["pred_boxes3d"]


def ioun_gaps(card) -> None:
    import numpy as np
    t0 = time.perf_counter()
    first = cs._stage2_batches(cs._stage2_cfg("ioun"),
                                1 + cs.BF16_TRAIN_STEPS)[0]
    for d in range(IOUN_DRAWS):
        host = {k: v[d * DRAW_CROPS:(d + 1) * DRAW_CROPS]
                for k, v in first.items()}
        cpu = _ioun_step(host, "bfloat16", "cpu")
        keys = [k for k in cpu if cpu[k].abs().max() > 0]

        def median_gap(a, ref):
            return float(np.median([cs._gap(a[k], ref[k]) for k in keys]))
        card_k = _ioun_step(host, "bfloat16", "cuda")
        with _plain_fused_sa():
            card_p = _ioun_step(host, "bfloat16", "cuda")
        f32 = _ioun_step(host, "float32", "cpu")
        orders = {}
        for o in SUM_ORDERS:
            with _reordered_bf16_sums(o):
                orders[o] = median_gap(_ioun_step(host, "bfloat16", "cpu"),
                                       cpu)
        note = (f"card (kernels) - CPU {median_gap(card_k, cpu):.4g}, card "
                f"(plain fused SA) - CPU {median_gap(card_p, cpu):.4g}, "
                f"card kernels - card plain {median_gap(card_k, card_p):.4g}"
                f"; the CPU's bf16 - f32 {median_gap(cpu, f32):.4g}; the "
                f"CPU's bf16 sums in another order - CPU: "
                + ", ".join(f"{o} {v:.4g}" for o, v in orders.items()))
        if d == 0:
            boxes = _cpu_trunk_boxes(host)
            got = [_ioun_step(host, "bfloat16", dev, frame=boxes)
                   for dev in ("cuda", "cpu")]
            note += (f"; from the CPU trunk's boxes (one frame) card - CPU "
                     f"{median_gap(*got):.4g}")
        print(f"# 2: {card}: IOUN bf16 step, crops {d * DRAW_CROPS}-"
              f"{(d + 1) * DRAW_CROPS - 1}, median gradient gap over "
              f"{len(keys)} tensors: {note}", flush=True)
    print(f"# 2: {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------------ 3.
@contextlib.contextmanager
def _eval_layers_rounded(rounded: bool):
    """With `rounded` False, the BN-free SA stacks' bf16 eval takes the
    fused SA's bf16 mode (f32 bias and layers) instead of the rounded-layer
    mode the package gives them."""
    import ws3d_tpu_torch.models.pointnet2 as pointnet2
    saved = pointnet2.fused_sa
    if not rounded:
        pointnet2.fused_sa = lambda *a, **kw: saved(
            *a, **{**kw, "round_layers": False})
    try:
        yield
    finally:
        pointnet2.fused_sa = saved


def eval_modes(card) -> None:
    from ws3d_tpu_torch.datasets import RPNDataset, SyntheticKitti
    from ws3d_tpu_torch.models import build_model
    from ws3d_tpu_torch.tools.diff_detections import diff
    from ws3d_tpu_torch.tools.eval_auto import run_eval
    from ws3d_tpu_torch.weights import load_npz

    t0 = time.perf_counter()
    cfg = cs._eval_cfg()
    src = SyntheticKitti(num_scenes=cs.EVAL_SCENES, points_per_scene=20000,
                         seed=3)
    runs = (("float32", "float32", True),
            ("bfloat16 (rounded-layer eval)", "bfloat16", True),
            ("bfloat16 (bf16-mode eval)", "bfloat16", False))
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, dtype, rounded) in enumerate(runs):
            cfg.TPU.COMPUTE_DTYPE = dtype
            model = build_model(cfg)
            load_npz(model, cs.WEIGHTS)
            stats = {}
            with _eval_layers_rounded(rounded):
                ret = run_eval(model, cfg, src, RPNDataset(
                    src, cfg, mode="EVAL", seed=0), cs._quiet_log(),
                    scenes=cs.EVAL_SCENES, batch=cs.BATCH,
                    output_dir=os.path.join(tmp, str(i)), stats=stats)
            ap = " / ".join(f"{ret[f'Car_3d_{d}']:.4f}"
                            for d in ("easy", "moderate", "hard"))
            line = (f"# 3: {card}: eval_auto on {cs.EVAL_SCENES} scenes, "
                    f"{name}: {stats['detections']} detections, Car 3D AP "
                    f"e/m/h {ap}")
            if i:
                rec = diff(*(os.path.join(tmp, str(j), "final_result",
                                          "data") for j in (i, 0)))
                line += f"; against f32 {json.dumps(rec)}"
            print(line, flush=True)
            del model
    print(f"# 3: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_gaps: no CUDA device is visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(cs.ROOT, "ws3d_tpu_torch")):
        print("chip_gaps: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, cs.ROOT)
    from ws3d_tpu_torch.device import card_line
    from ws3d_tpu_torch.ops import _kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    _kernels.build()
    _kernels.library()
    global_step_orders(card)
    ioun_gaps(card)
    eval_modes(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
