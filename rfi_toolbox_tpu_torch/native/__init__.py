"""Native (C++) host I/O, bound via ctypes."""

from .fastio import FastNpyReader, fastio_available, iter_npy_prefetched

__all__ = ["FastNpyReader", "iter_npy_prefetched", "fastio_available"]
