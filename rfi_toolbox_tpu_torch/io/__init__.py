"""Flagging entry points."""

from .flagging import flag_waterfalls

__all__ = ["flag_waterfalls"]
