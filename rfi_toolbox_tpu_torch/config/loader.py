"""YAML configuration loading for training and data generation.

A copy of ``rfi_toolbox_tpu/config/loader.py`` (the same schema, defaults
and messages, so that every YAML under ``configs/`` loads to the same
values in both packages): ``DataConfig`` preserves the nested YAML
structure with attribute+dict access for generation configs;
``TrainingConfig`` is a flat validated dataclass built by flattening the
nested sections (model / training / dataset / processing / output /
ms_loading).

As in the JAX package, ``device`` validates against {tpu, cpu, cuda}
(the shipped configs say ``tpu``); the port's commands take the device
from their ``--device`` flag, not from the config. ``mesh_shape``,
``data_axis``, ``compute_dtype`` and ``seed`` are training options.
"""

from dataclasses import dataclass
from pathlib import Path
from typing import Any

import yaml

__all__ = ["DataConfig", "TrainingConfig", "ConfigLoader"]


class DataConfig:
    """Recursive dict->attribute wrapper, also dict-like
    (get/__getitem__/items/__contains__)."""

    def __init__(self, data: dict):
        self._data = data
        for key, value in data.items():
            if isinstance(value, dict):
                setattr(self, key, DataConfig(value))
            else:
                setattr(self, key, value)

    def get(self, key, default=None):
        return self._data.get(key, default)

    def __contains__(self, key):
        return key in self._data

    def __getitem__(self, key):
        return self._data[key]

    def items(self):
        return self._data.items()

    def to_dict(self):
        return self._data


@dataclass
class TrainingConfig:
    """Flat, validated training configuration."""

    # Model configuration
    model_checkpoint: str = "large"
    model_type: str = "unet"
    in_channels: int = 3
    init_features: int = 32
    # UNet normalization layer ("batch" = reference BatchNorm2d parity;
    # "group" drops the running statistics; "none")
    norm: str = "batch"
    freeze_encoders: bool = True

    # Training hyperparameters
    num_epochs: int = 5
    batch_size: int = 4
    learning_rate: float = 1e-5
    weight_decay: float = 0.0
    device: str = "tpu"
    compute_dtype: str = "bfloat16"
    seed: int = 0

    # Optimizer settings
    optimizer: str = "adam"
    adam_betas: tuple = (0.9, 0.999)
    adam_eps: float = 1e-8
    momentum: float = 0.9

    # Loss function settings
    loss_function: str = "dicece"
    loss_sigmoid: bool = True
    loss_squared_pred: bool = True
    loss_reduction: str = "mean"

    # Model architecture flags (kept for schema compatibility)
    multimask_output: bool = False
    freeze_vision_encoder: bool = True
    freeze_prompt_encoder: bool = True

    # Data augmentation
    bbox_perturbation: int = 20

    # Loader/throughput settings (schema compatibility; device batches
    # replace DataLoader workers)
    num_workers: int = 0
    prefetch_factor: int = 2
    persistent_workers: bool = True
    pin_memory: bool = True

    # Logging
    log_interval: int = 100
    cuda_cache_clear_interval: int = 100

    # Parallelism
    mesh_shape: tuple | None = None
    data_axis: str = "data"

    # Dataset configuration
    stretch: str | None = "SQRT"
    flag_sigma: int = 5
    patch_method: str = "patchify"
    patch_size: int = 128
    num_patches: int | None = None
    apply_stretching: bool = True
    custom_flag: bool = True

    # Output configuration
    dir_path: str = "./rfi_tpu_data"
    save_plots: bool = True
    plot_dpi: int = 300
    plot: bool = True
    save_model: bool = True

    # MS loading configuration
    num_antennas: int | None = None
    data_mode: str = "DATA"

    def __post_init__(self):
        """Validate (skip None values), reference loader.py:107-149."""
        if self.model_checkpoint is not None:
            valid = ["tiny", "small", "base_plus", "large"]
            if self.model_checkpoint not in valid:
                raise ValueError(
                    f"Invalid model_checkpoint '{self.model_checkpoint}'. "
                    f"Must be one of: {valid}"
                )
        if self.stretch is not None:
            if self.stretch not in ["SQRT", "LOG10"]:
                raise ValueError(
                    f"Invalid stretch '{self.stretch}'. "
                    "Must be one of: ['SQRT', 'LOG10'] or null"
                )
        if self.device is not None:
            valid = ["tpu", "cpu", "cuda"]
            if self.device not in valid:
                raise ValueError(
                    f"Invalid device '{self.device}'. Must be one of: {valid}"
                )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"Invalid compute_dtype '{self.compute_dtype}'. "
                "Must be 'float32' or 'bfloat16'"
            )
        if self.norm not in ("batch", "group", "none"):
            raise ValueError(
                f"Invalid norm '{self.norm}'. "
                "Must be one of: ['batch', 'group', 'none']"
            )
        for name in ("num_epochs", "batch_size", "learning_rate", "flag_sigma",
                     "patch_size"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")


class ConfigLoader:
    """Load and validate YAML configuration files."""

    @staticmethod
    def load_training(config_path: str) -> TrainingConfig:
        """YAML -> validated TrainingConfig (reference loader.py:157-197)."""
        config_file = Path(config_path)
        if not config_file.exists():
            raise FileNotFoundError(f"Configuration file not found: {config_path}")
        with open(config_file) as f:
            try:
                config_dict = yaml.safe_load(f)
            except yaml.YAMLError as e:
                raise yaml.YAMLError(f"Failed to parse YAML config: {e}") from e
        if config_dict is None:
            raise ValueError(f"Empty configuration file: {config_path}")
        flat = ConfigLoader._flatten_config(config_dict)
        try:
            return TrainingConfig(**flat)
        except TypeError as e:
            raise ValueError(f"Invalid configuration parameters: {e}") from e

    @staticmethod
    def _flatten_config(config_dict: dict[str, Any]) -> dict[str, Any]:
        """Flatten nested sections to TrainingConfig kwargs
        (reference loader.py:199-310, plus the mesh, dtype and seed keys)."""
        flat: dict[str, Any] = {}

        if "model" in config_dict:
            m = config_dict["model"]
            flat["model_checkpoint"] = m.get("checkpoint", "large")
            flat["freeze_encoders"] = m.get("freeze_encoders", True)
            for k in ("model_type", "in_channels", "init_features"):
                if k in m:
                    flat[k] = m[k]

        if "training" in config_dict:
            t = config_dict["training"]
            for k, d in [
                ("num_epochs", 5), ("batch_size", 4), ("learning_rate", 1e-5),
                ("weight_decay", 0.0), ("device", "tpu"),
                ("optimizer", "adam"), ("adam_eps", 1e-8), ("momentum", 0.9),
                ("loss_function", "dicece"), ("loss_sigmoid", True),
                ("loss_squared_pred", True), ("loss_reduction", "mean"),
                ("multimask_output", False), ("freeze_vision_encoder", True),
                ("freeze_prompt_encoder", True), ("bbox_perturbation", 20),
                ("num_workers", 0), ("prefetch_factor", 2),
                ("persistent_workers", True), ("pin_memory", True),
                ("log_interval", 100), ("cuda_cache_clear_interval", 100),
                ("compute_dtype", "bfloat16"), ("seed", 0),
            ]:
                flat[k] = t.get(k, d)
            flat["adam_betas"] = tuple(t.get("adam_betas", (0.9, 0.999)))
            if "model_checkpoint" in t:
                flat["model_checkpoint"] = t["model_checkpoint"]
            if "mesh_shape" in t and t["mesh_shape"] is not None:
                flat["mesh_shape"] = tuple(t["mesh_shape"])
            for k in ("plot", "save_model"):
                if k in t:
                    flat[k] = t[k]
            if "output_dir" in t:
                flat["dir_path"] = t["output_dir"]

        if "dataset" in config_dict:
            d = config_dict["dataset"]
            stretch = d.get("stretch", "SQRT")
            flat["stretch"] = None if stretch in (None, "null", "None") else stretch
            flat["flag_sigma"] = d.get("flag_sigma", 5)
            flat["patch_method"] = d.get("patch_method", "patchify")
            flat["patch_size"] = d.get("patch_size", 128)
            flat["num_patches"] = d.get("num_patches", None)
            flat["apply_stretching"] = d.get("apply_stretching", True)
            flat["custom_flag"] = d.get("custom_flag", True)

        if "processing" in config_dict:
            p = config_dict["processing"]
            if "stretch" in p:
                stretch = p["stretch"]
                flat["stretch"] = None if stretch in (None, "null", "None") else stretch
            for k in ("flag_sigma", "patch_size", "apply_stretching"):
                if k in p:
                    flat[k] = p[k]

        if "output" in config_dict:
            o = config_dict["output"]
            flat["dir_path"] = o.get("dir_path", "./rfi_tpu_data")
            flat["save_plots"] = o.get("save_plots", True)
            flat["plot_dpi"] = o.get("plot_dpi", 300)

        if "ms_loading" in config_dict:
            ms = config_dict["ms_loading"]
            flat["num_antennas"] = ms.get("num_antennas", None)
            flat["data_mode"] = ms.get("data_mode", "DATA")

        return flat

    @staticmethod
    def load_data(config_path: str) -> DataConfig:
        """YAML -> nested DataConfig for generation (loader.py:312-343)."""
        config_file = Path(config_path)
        if not config_file.exists():
            raise FileNotFoundError(f"Configuration file not found: {config_path}")
        with open(config_file) as f:
            try:
                config_dict = yaml.safe_load(f)
            except yaml.YAMLError as e:
                raise yaml.YAMLError(f"Failed to parse YAML config: {e}") from e
        if config_dict is None:
            raise ValueError(f"Empty configuration file: {config_path}")
        return DataConfig(config_dict)

    @staticmethod
    def load(config_path: str) -> TrainingConfig:
        """Alias of load_training (backwards compatibility)."""
        return ConfigLoader.load_training(config_path)

    @staticmethod
    def save(config: TrainingConfig, output_path: str):
        """TrainingConfig -> nested YAML (round-trips via load_training)."""
        config_dict = {
            "model": {
                "checkpoint": config.model_checkpoint,
                "model_type": config.model_type,
                "in_channels": config.in_channels,
                "init_features": config.init_features,
                "freeze_encoders": config.freeze_encoders,
            },
            "training": {
                "device": config.device,
                "compute_dtype": config.compute_dtype,
                "seed": config.seed,
                "num_epochs": config.num_epochs,
                "batch_size": config.batch_size,
                "learning_rate": config.learning_rate,
                "model_checkpoint": config.model_checkpoint,
                "optimizer": config.optimizer,
                "weight_decay": config.weight_decay,
                "adam_betas": list(config.adam_betas),
                "adam_eps": config.adam_eps,
                "loss_function": config.loss_function,
                "loss_sigmoid": config.loss_sigmoid,
                "loss_squared_pred": config.loss_squared_pred,
                "loss_reduction": config.loss_reduction,
                "multimask_output": config.multimask_output,
                "freeze_vision_encoder": config.freeze_vision_encoder,
                "freeze_prompt_encoder": config.freeze_prompt_encoder,
                "bbox_perturbation": config.bbox_perturbation,
                "num_workers": config.num_workers,
                "prefetch_factor": config.prefetch_factor,
                "persistent_workers": config.persistent_workers,
                "pin_memory": config.pin_memory,
                "log_interval": config.log_interval,
                "cuda_cache_clear_interval": config.cuda_cache_clear_interval,
                "mesh_shape": list(config.mesh_shape) if config.mesh_shape else None,
                "plot": config.plot,
                "save_model": config.save_model,
            },
            "dataset": {
                "stretch": config.stretch,
                "flag_sigma": config.flag_sigma,
                "patch_method": config.patch_method,
                "patch_size": config.patch_size,
                "num_patches": config.num_patches,
                "apply_stretching": config.apply_stretching,
                "custom_flag": config.custom_flag,
            },
            "output": {
                "dir_path": config.dir_path,
                "save_plots": config.save_plots,
                "plot_dpi": config.plot_dpi,
            },
        }
        if config.num_antennas is not None:
            config_dict["ms_loading"] = {
                "num_antennas": config.num_antennas,
                "data_mode": config.data_mode,
            }
        with open(output_path, "w") as f:
            yaml.dump(config_dict, f, default_flow_style=False, sort_keys=False)

    @staticmethod
    def create_default_config(output_path: str):
        """Write a default configuration YAML."""
        ConfigLoader.save(TrainingConfig(), output_path)
