"""Train step (training/trainer.py, the step_fn call of
Trainer.train_steps): host ms a step inside the program's own
`trainer.step` spans, from the forward's launch to the optimizer's last
(ws3d_tpu_torch.utils.profiling.TRACE; None from a program without
them). Per recorded call: the traced stretch cuts its first and last
steps."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    s = TRACE.totals()["spans"].get("trainer.step")
    return s["host_s"] * 1e3 / s["calls"] if s else None
