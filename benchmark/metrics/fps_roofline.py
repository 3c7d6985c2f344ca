"""Kernel 1 (ops/sampling.py on csrc/fps.cu): the sum of the calls' least
times over the device time of the kernels launched inside their spans,
in %."""
from benchmark.metrics.common import fps_roofline as read  # noqa: F401
