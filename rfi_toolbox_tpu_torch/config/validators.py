"""Standalone configuration validators.

A copy of ``rfi_toolbox_tpu/config/validators.py`` (the reference's
config/validators.py:13-136): the same rules and messages; they raise
:class:`ConfigValidationError` early, before an expensive pipeline runs.
"""

from pathlib import Path

from ..utils.errors import ConfigValidationError

__all__ = [
    "validate_preprocessing_config",
    "validate_training_config",
    "validate_paths_exist",
    "validate_all",
]


def _get(config, key, default=None):
    if hasattr(config, "get"):
        return config.get(key, default)
    return getattr(config, key, default)


def validate_preprocessing_config(config):
    """patch_size in {128, 256, 512, 1024}; stretch in {None, SQRT,
    LOG10}; rotations in {1, 2, 4}."""
    patch_size = _get(config, "patch_size", 128)
    if patch_size not in [128, 256, 512, 1024]:
        raise ConfigValidationError(
            f"patch_size must be 128, 256, 512, or 1024. Got: {patch_size}"
        )
    stretch = _get(config, "stretch")
    if stretch not in [None, "SQRT", "LOG10"]:
        raise ConfigValidationError(
            f"stretch must be None, 'SQRT', or 'LOG10'. Got: {stretch}"
        )
    aug_rot = _get(config, "augmentation_rotations", 4)
    if aug_rot not in [1, 2, 4]:
        raise ConfigValidationError(
            f"augmentation_rotations must be 1, 2, or 4. Got: {aug_rot}"
        )
    return True


def validate_training_config(config):
    """Checkpoint name, batch size 1-128, learning rate in (0, 1]."""
    ckpt = _get(config, "sam_checkpoint", "large")
    if ckpt not in ["tiny", "small", "base_plus", "large"]:
        raise ConfigValidationError(
            f"sam_checkpoint must be tiny/small/base_plus/large. Got: {ckpt}"
        )
    batch_size = _get(config, "batch_size", 8)
    if batch_size < 1 or batch_size > 128:
        raise ConfigValidationError(f"batch_size must be 1-128. Got: {batch_size}")
    lr = _get(config, "learning_rate", 1e-4)
    if lr <= 0 or lr > 1:
        raise ConfigValidationError(f"learning_rate must be in (0, 1]. Got: {lr}")
    return True


def validate_paths_exist(config):
    """dataset / ms_path / model_path entries must exist on disk."""
    for key, label in [
        ("dataset", "Dataset path"),
        ("ms_path", "Measurement set"),
        ("model_path", "Model checkpoint"),
    ]:
        if hasattr(config, "__contains__") and key in config:
            path = Path(config[key])
            if not path.exists():
                raise ConfigValidationError(f"{label} does not exist: {path}")
    return True


def validate_all(config):
    """Run every applicable validator."""
    if hasattr(config, "processing"):
        validate_preprocessing_config(config.processing)
    if hasattr(config, "training"):
        validate_training_config(config.training)
    config_dict = config.__dict__ if hasattr(config, "__dict__") else config
    validate_paths_exist(config_dict)
    return True
