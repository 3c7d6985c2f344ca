"""Pipeline glue, the stage-2 compaction (pipeline/inference.py,
make_two_stage_fn: each pool's selection, from the live mask to the crops
and rows a net takes, with the host's wait for the trunk at the boolean
index): host ms a batch inside the program's own `inference.compact`
spans (ws3d_tpu_torch.utils.profiling.TRACE; None from a program without
them)."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    s = TRACE.totals()["spans"].get("inference.compact")
    return s["host_s"] * 1e3 / rec["iters"] if s else None
