"""Training: optimizer and schedules, the stage-1 and stage-2 train steps
and Trainer, train-state checkpoints, in-training validation."""
from ws3d_tpu_torch.training.checkpoint import (  # noqa: F401
    load_part_checkpoint, restore_train_state, save_train_state)
from ws3d_tpu_torch.training.optim import (  # noqa: F401
    AdamOneCycle, bn_momentum_schedule, onecycle_momentum, onecycle_schedule)
from ws3d_tpu_torch.training.trainer import (  # noqa: F401
    Trainer, make_rcnn_loss_fn, make_rcnn_train_step, make_rpn_loss_fn,
    make_rpn_train_step)
from ws3d_tpu_torch.training.validation import (  # noqa: F401
    Validator, make_val_fn)
