"""Loader, as the train step sees it: host ms the Trainer waits for a
host batch on the prefetch queue (utils/prefetch.py, the consumer's
q.get()), a call, inside the program's own `prefetch.wait` spans
(ws3d_tpu_torch.utils.profiling.TRACE; None from a program without
them). Per recorded call, since the traced stretch cuts its ends."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    s = TRACE.totals()["spans"].get("prefetch.wait")
    return s["host_s"] * 1e3 / s["calls"] if s else None
