"""Train step, stage 1's train-mode BatchNorm + ReLU: the calls a step of
the fused path (ops/batchnorm.bn_relu_train), the program's
`bn_relu.fused` counter over the traced steps (record["iters"]): 34 a
stage-1 step (24 SA, 8 FP and 2 head layers), a count the host's speed
does not move; 0 shows traffic that bypasses the fused path
(ws3d_tpu_torch.utils.profiling.TRACE; None from a program without it).
The counter is added at each forward call, so every traced step counts
whole, where the `trainer.step` spans lose the stretch's first and last."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    n = TRACE.totals()["counters"].get("bn_relu.fused")
    return n / rec["iters"] if n is not None and rec.get("iters") else None
