"""Training (counterpart of sparch_tpu/train): the training state, the
train and eval steps, the plateau schedule, checkpoints and the epoch loop
(``train.loop.Experiment``)."""
from sparch_tpu_torch.train.checkpoint import (
    checkpoint_exists,
    restore_checkpoint,
    save_checkpoint,
)
from sparch_tpu_torch.train.schedule import ReduceLROnPlateau
from sparch_tpu_torch.train.state import TrainState, create_train_state
from sparch_tpu_torch.train.steps import make_eval_step, make_train_step

__all__ = [
    "ReduceLROnPlateau",
    "TrainState",
    "create_train_state",
    "make_train_step",
    "make_eval_step",
    "save_checkpoint",
    "restore_checkpoint",
    "checkpoint_exists",
]
