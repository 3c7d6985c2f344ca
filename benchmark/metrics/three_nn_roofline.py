"""Kernel 7 (ops/interpolate.three_nn_cuda on csrc/three_nn.cu, the 3-NN
search of the FP interpolation's backward): the sum of the calls' least
times (benchmark/roofline/stage1_counts.py) over the device time of the
kernels launched inside their spans, in %."""
from benchmark.metrics.common import roofline_pct
from benchmark.roofline.stage1_counts import bound_s


def read(rec):
    return roofline_pct(rec, "three_nn", bound_s)
