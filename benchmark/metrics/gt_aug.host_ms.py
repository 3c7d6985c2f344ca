"""Loader, the GT-database copy-paste augmentation
(datasets/gt_database.apply_gt_aug, called from RPNDataset.get_sample on
the prefetch thread): host ms a sample inside the program's own
`loader.gt_aug` spans, over the samples of its `loader.sample` spans,
waiting for the GIL included (ws3d_tpu_torch.utils.profiling.TRACE; None
from a program without them)."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    spans = TRACE.totals()["spans"]
    s, n = spans.get("loader.gt_aug"), spans.get("loader.sample")
    return s["host_s"] * 1e3 / n["calls"] if s and n else None
