"""Compatibility alias: reference import path
``rfi_toolbox.preprocessing`` (preprocessing/__init__.py:7)."""

from ..preprocess import DevicePreprocessor, GPUPreprocessor, Preprocessor, patchify

__all__ = ["Preprocessor", "GPUPreprocessor", "DevicePreprocessor", "patchify"]
