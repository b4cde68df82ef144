"""Waterfall -> patch preprocessing: the plain pipeline, the static
virtual-augmentation path, the Preprocessor and the raw-patch
DevicePreprocessor."""

from . import pipeline, static_prep
from .pipeline import patchify
from .preprocessor import DevicePreprocessor, GPUPreprocessor, Preprocessor

__all__ = ["pipeline", "static_prep", "patchify", "Preprocessor",
           "DevicePreprocessor", "GPUPreprocessor"]
