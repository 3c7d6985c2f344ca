"""Stage-1 net, the set abstraction (models/pointnet2.PointnetSAModuleMSG,
train mode: FPS, the multi-scale ball query, the gather, the MLP with
BatchNorm and ReLU, the max): device ms a step of the forward's kernels
launched inside the backbone's SA modules."""
from benchmark.metrics.common import span_device_ms


def read(rec):
    return span_device_ms(rec, "sa")
