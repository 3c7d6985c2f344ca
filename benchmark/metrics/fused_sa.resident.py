"""Kernels 2 and 3 in bf16 (ops/fused_sa.py on csrc/fused_sa.cu): the calls
a batch (record["iters"]: batches at 64, scenes at 1) that took the
weight-stationary route, the program's `fused_sa.resident` counter over the
traced stretch (ws3d_tpu_torch.utils.profiling.TRACE). A coverage count
that the host's speed does not move: it reads the route's calls of the
model (stage 1's SA0 and SA1 at both scales, the trunk's and the
cascade's three sampled SA levels), 0 for traffic that bypasses the route;
None from a program without the counter."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    n = TRACE.totals()["counters"].get("fused_sa.resident")
    return n / rec["iters"] if n is not None and rec.get("iters") else None
