"""Synthetic RFI waterfalls on the card (with exact masks, or one mask
per event for the instance model), and the config-driven dataset
generator that writes them to disk."""

from . import events
from .generator import RawPatchDataset, SyntheticDataGenerator
from .sample import (
    generate_bandpass,
    make_instance_sample_generator,
    make_sample_generator,
    params_to_event_list,
)
from .simulator import RFISimulator

__all__ = ["events", "generate_bandpass", "make_sample_generator",
           "make_instance_sample_generator",
           "params_to_event_list", "SyntheticDataGenerator", "RawPatchDataset",
           "RFISimulator"]
