"""Stage-1 training: optimizer and schedules, the train step and Trainer,
train-state checkpoints."""
from ws3d_tpu_torch.training.checkpoint import (  # noqa: F401
    restore_train_state, save_train_state)
from ws3d_tpu_torch.training.optim import (  # noqa: F401
    AdamOneCycle, bn_momentum_schedule, onecycle_momentum, onecycle_schedule)
from ws3d_tpu_torch.training.trainer import (  # noqa: F401
    Trainer, make_rpn_loss_fn, make_rpn_train_step)
