"""Stage-2 net (models/rcnn.py, trunk and cascade): device ms a batch of
the kernels launched inside the `rcnn_trunk_forward` and `ioun_forward`
spans."""
from benchmark.metrics.common import span_device_ms


def read(rec):
    return span_device_ms(rec, "stage2_trunk", "stage2_cascade")
