"""Host dump (datasets/kitti_io.save_kitti_format on the writer thread):
ms the writer spends on a batch's txt files, waiting for the GIL
included."""
from benchmark.metrics.common import mean_ms


def read(rec):
    return mean_ms(rec, "dump_s")
