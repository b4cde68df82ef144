"""Compatibility alias: reference import path ``rfi_toolbox.datasets``
(datasets/__init__.py:7-10)."""

from ..data import ArrayDataset, BatchWriter, RFIMaskDataset, TorchDataset, load_batches

__all__ = [
    "TorchDataset",
    "ArrayDataset",
    "BatchWriter",
    "RFIMaskDataset",
    "load_batches",
]
