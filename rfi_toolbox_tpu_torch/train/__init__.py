"""Training: losses, the optimiser state, the train steps and ``Trainer``."""

from .losses import bce_dice_loss, bce_with_logits_loss, dice_loss
from .trainer import (
    Trainer,
    TrainState,
    create_train_state,
    eval_step,
    export_params,
    load_params,
    train_step,
    train_steps,
)

__all__ = [
    "TrainState",
    "Trainer",
    "export_params",
    "load_params",
    "create_train_state",
    "train_step",
    "train_steps",
    "eval_step",
    "bce_dice_loss",
    "bce_with_logits_loss",
    "dice_loss",
]
