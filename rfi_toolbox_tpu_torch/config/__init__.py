"""Configuration loading and validation."""

from .loader import ConfigLoader, DataConfig, TrainingConfig
from .validators import (
    validate_all,
    validate_paths_exist,
    validate_preprocessing_config,
    validate_training_config,
)

__all__ = [
    "DataConfig",
    "TrainingConfig",
    "ConfigLoader",
    "validate_preprocessing_config",
    "validate_training_config",
    "validate_paths_exist",
    "validate_all",
]
