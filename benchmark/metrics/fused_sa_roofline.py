"""Kernels 2 and 3 (ops/fused_sa.py on csrc/fused_sa.cu, every mode; in
training the forward, at three TF32 passes): the sum of the calls' least
times (benchmark/roofline/counts.py, at the peak of each call's mode) over
the device time of the kernels launched inside their spans, in %."""
from benchmark.metrics.common import fused_sa_roofline as read  # noqa: F401
