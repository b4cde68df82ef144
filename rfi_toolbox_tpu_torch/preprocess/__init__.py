"""Waterfall -> patch preprocessing (plain PyTorch)."""

from . import pipeline

__all__ = ["pipeline"]
