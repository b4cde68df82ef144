"""Console entry points: ``python -m rfi_toolbox_tpu_torch.cli.<name>``
(the JAX package's ``[project.scripts]`` commands)."""

__all__ = [
    "generate_dataset",
    "train_model",
    "evaluate_model",
    "normalize_data",
]
