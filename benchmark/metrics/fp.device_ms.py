"""Stage-1 net, the feature propagation (models/pointnet2.PointnetFPModule,
train mode: the 3-NN interpolation, the skip concat, the MLP with
BatchNorm and ReLU): device ms a step of the forward's kernels launched
inside the backbone's FP modules."""
from benchmark.metrics.common import span_device_ms


def read(rec):
    return span_device_ms(rec, "fp")
