"""Loader (datasets/boxplace_dataset.BoxPlaceDataset.get_sample on the
prefetch thread): host ms a sample inside the program's own
`loader.sample` spans, waiting for the GIL included
(ws3d_tpu_torch.utils.profiling.TRACE; None from a program without
them)."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    s = TRACE.totals()["spans"].get("loader.sample")
    return s["host_s"] * 1e3 / s["calls"] if s else None
