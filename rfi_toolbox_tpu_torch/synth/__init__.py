"""Synthetic RFI waterfalls on the card."""

from . import events
from .sample import generate_bandpass, make_sample_generator

__all__ = ["events", "generate_bandpass", "make_sample_generator"]
