"""The whole batch or step: the model's FLOPs in the traced window (every
MLP, FP layer and head, stage 2 at the pool sizes it ran;
benchmark/roofline/counts.py) over the window's seconds times the peak,
in %. Inference counts the forward at the bf16 peak of 989 TFLOP/s;
training counts three times the forward at the float32 peak of
67 TFLOP/s (the configuration computes in float32; TF32 is not
float32)."""
from benchmark.metrics.common import mfu_pct
from benchmark.roofline import peaks


def read(rec):
    if rec.get("kind") == "train":
        return mfu_pct(rec, 3.0, peaks.F32_FLOP_S)
    return mfu_pct(rec, 1.0, peaks.BF16_FLOP_S)
