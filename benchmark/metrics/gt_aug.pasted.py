"""Loader, the GT-database copy-paste augmentation: the boxes pasted into
a sample, the program's `loader.gt_pasted` counter over the samples of its
`loader.sample` spans, a count the host's speed does not move; 0 shows
traffic that does not augment (ws3d_tpu_torch.utils.profiling.TRACE; None
from a program without them)."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    tot = TRACE.totals()
    n = tot["counters"].get("loader.gt_pasted")
    s = tot["spans"].get("loader.sample")
    return None if n is None or not s else n / s["calls"]
