"""Training: losses, the optimiser state and the train steps."""

from .losses import bce_dice_loss, bce_with_logits_loss, dice_loss
from .trainer import TrainState, create_train_state, eval_step, train_step, train_steps

__all__ = [
    "TrainState",
    "create_train_state",
    "train_step",
    "train_steps",
    "eval_step",
    "bce_dice_loss",
    "bce_with_logits_loss",
    "dice_loss",
]
