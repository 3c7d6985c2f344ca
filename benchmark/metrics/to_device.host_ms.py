"""Train step, the batch's copy to the card (training/trainer.py,
Trainer._step_batch: pageable host arrays, so each copy first waits for
the stream): host ms a step inside the program's own `trainer.to_device`
spans (ws3d_tpu_torch.utils.profiling.TRACE; None from a program without
them). Per recorded call, since the traced stretch cuts its ends."""


def read(rec):
    try:
        from ws3d_tpu_torch.utils.profiling import TRACE
    except ImportError:
        return None
    s = TRACE.totals()["spans"].get("trainer.to_device")
    return s["host_s"] * 1e3 / s["calls"] if s else None
