"""Device helpers."""

from .device import resolve_device, set_tf32

__all__ = ["resolve_device", "set_tf32"]
