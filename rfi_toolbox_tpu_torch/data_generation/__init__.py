"""Compatibility alias: reference import path
``rfi_toolbox.data_generation`` (data_generation/__init__.py:7)."""

from ..synth import RawPatchDataset, SyntheticDataGenerator

__all__ = ["SyntheticDataGenerator", "RawPatchDataset"]
