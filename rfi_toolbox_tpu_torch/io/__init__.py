"""Flagging entry points."""

from .flagging import flag_waterfalls, flag_waterfalls_coherent

__all__ = ["flag_waterfalls", "flag_waterfalls_coherent"]
