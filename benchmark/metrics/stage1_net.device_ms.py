"""Stage-1 net (models/backbone.py, pointnet2.py, rpn.py): device ms a
batch of the kernels launched inside the `rpn_forward` span."""
from benchmark.metrics.common import span_device_ms


def read(rec):
    return span_device_ms(rec, "stage1_net")
