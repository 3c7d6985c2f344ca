"""Pipeline glue, the greedy sweeps (ops/nms.greedy_suppress: the
proposal layer's 512-step radius NMS and finalize's 64-step self-NMS):
host ms a batch inside the program's own `nms.sweep` spans
(ws3d_tpu_torch.utils.profiling.TRACE; None from a program without
them)."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    s = TRACE.totals()["spans"].get("nms.sweep")
    return s["host_s"] * 1e3 / rec["iters"] if s else None
