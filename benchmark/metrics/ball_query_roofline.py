"""Kernel 6 (ops/ball_query.ball_query_multi_cuda on csrc/ball_query.cu,
the train-mode SA's multi-scale ball query): the sum of the calls' least
times (benchmark/roofline/stage1_counts.py) over the device time of the
kernels launched inside their spans, in %."""
from benchmark.metrics.common import roofline_pct
from benchmark.roofline.stage1_counts import bound_s


def read(rec):
    return roofline_pct(rec, "ball_query", bound_s)
