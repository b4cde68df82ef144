"""In-memory dataset container."""

from .batched_dataset import ArrayDataset, TorchDataset

__all__ = ["ArrayDataset", "TorchDataset"]
