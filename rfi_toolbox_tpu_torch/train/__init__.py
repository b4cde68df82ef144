"""Training: losses, the optimiser state, the train steps, ``Trainer``,
the raw-patch ``RawPatchTrainer``, the coherent 8-channel
``CoherentTrainer`` and SOLOLite's ``InstanceTrainer``."""

from .coherent_trainer import CoherentTrainer, coherent_batch
from .instance_trainer import (
    InstanceTrainer,
    make_instance_fused_steps,
    make_instance_train_step,
)
from .losses import bce_dice_loss, bce_with_logits_loss, dice_loss
from .raw_patches import RawPatchTrainer, augment_batch, make_raw_patch_step
from .trainer import (
    Trainer,
    TrainState,
    create_train_state,
    eval_step,
    export_params,
    load_params,
    train_step,
    train_steps,
    warmup_cosine_decay_schedule,
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
    "RawPatchTrainer",
    "augment_batch",
    "make_raw_patch_step",
    "CoherentTrainer",
    "coherent_batch",
    "warmup_cosine_decay_schedule",
    "InstanceTrainer",
    "make_instance_train_step",
    "make_instance_fused_steps",
]
