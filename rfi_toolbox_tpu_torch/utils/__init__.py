"""Utilities: device resolution, errors, profiling, progress bars."""

from .device import resolve_device, set_tf32
from .errors import ConfigValidationError, DataShapeError, RFIToolboxError
from .profiling import StepTimer, annotate, trace
from .progress import progress

__all__ = [
    "resolve_device",
    "set_tf32",
    "progress",
    "RFIToolboxError",
    "ConfigValidationError",
    "DataShapeError",
    "StepTimer",
    "annotate",
    "trace",
]
