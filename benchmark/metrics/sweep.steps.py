"""Pipeline glue, the greedy sweeps: the host-issued steps a batch of the
program's `nms.sweep_steps` counter (ops/nms.greedy_suppress adds its K
at each call: 512 for the proposal layer, 64 for finalize), a count the
host's speed does not move (ws3d_tpu_torch.utils.profiling.TRACE; None
from a program without it)."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    n = TRACE.totals()["counters"].get("nms.sweep_steps")
    return n / rec["iters"] if n else None
