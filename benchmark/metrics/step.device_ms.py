"""Train step (training/trainer.py, losses.py, the train branch of
models/rcnn.py): device ms a step of the kernels launched inside the step
span."""
from benchmark.metrics.common import span_device_ms


def read(rec):
    return span_device_ms(rec, "step")
