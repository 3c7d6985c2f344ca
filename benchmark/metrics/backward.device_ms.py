"""Train step, the backward: device ms a step of the kernels launched
inside the `torch.autograd.grad` span (mostly the given-index VJP of the
fused SA)."""
from benchmark.metrics.common import span_device_ms


def read(rec):
    return span_device_ms(rec, "backward")
