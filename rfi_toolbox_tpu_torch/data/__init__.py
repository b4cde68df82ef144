"""In-memory dataset container."""

from .batched_dataset import ArrayDataset

__all__ = ["ArrayDataset"]
