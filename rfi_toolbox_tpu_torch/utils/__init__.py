"""Device helpers and host-side progress reporting."""

from .device import resolve_device, set_tf32
from .progress import progress

__all__ = ["resolve_device", "set_tf32", "progress"]
