"""Visualization (host-side, optional bokeh/matplotlib)."""

from . import visualize

__all__ = ["visualize"]
