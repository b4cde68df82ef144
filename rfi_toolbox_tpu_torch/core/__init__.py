"""Compatibility alias: reference import path ``rfi_toolbox.core``
(core/__init__.py:12 exports RFISimulator)."""

from ..synth.simulator import RFISimulator

__all__ = ["RFISimulator"]
