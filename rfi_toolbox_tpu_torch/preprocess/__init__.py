"""Waterfall -> patch preprocessing: the plain pipeline, the static
virtual-augmentation path and the Preprocessor."""

from . import pipeline, static_prep
from .preprocessor import Preprocessor

__all__ = ["pipeline", "static_prep", "Preprocessor"]
