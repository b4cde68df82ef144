"""Compatibility alias: reference import path ``rfi_toolbox.scripts``
(the console entry points live in ``rfi_toolbox_tpu_torch.cli``)."""

from ..cli import evaluate_model, generate_dataset, normalize_data, train_model

# reference script-module name
normalize_rfi_data = normalize_data

__all__ = [
    "generate_dataset",
    "train_model",
    "evaluate_model",
    "normalize_rfi_data",
]
