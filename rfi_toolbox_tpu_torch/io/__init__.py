"""Measurement Set I/O and flagging entry points.

``MSLoader`` reads a Measurement Set through casatools (optional,
imported only when a path is opened) or the in-memory :class:`FakeMS`;
importing this package never needs CASA.
"""

from .fake_ms import FakeMS, FakeTable, make_fake_ms
from .flagging import flag_measurement_set, flag_waterfalls, flag_waterfalls_coherent
from .ms_injection import inject_synthetic_data
from .ms_loader import MSLoader

try:  # pragma: no cover - depends on the environment
    import casatools  # noqa: F401

    CASA_AVAILABLE = True
except ImportError:
    CASA_AVAILABLE = False

__all__ = [
    "MSLoader",
    "inject_synthetic_data",
    "flag_measurement_set",
    "flag_waterfalls",
    "flag_waterfalls_coherent",
    "FakeMS",
    "FakeTable",
    "make_fake_ms",
    "CASA_AVAILABLE",
]
