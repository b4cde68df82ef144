"""Dataset containers, on-disk batch storage, and the sample-directory
``RFIMaskDataset`` (from a Measurement Set too)."""

from .batched_dataset import (
    ArrayDataset,
    BatchWriter,
    StreamingDataset,
    TorchDataset,
    load_batches,
)
from .rfi_mask_dataset import RFIMaskDataset

__all__ = [
    "ArrayDataset",
    "TorchDataset",
    "BatchWriter",
    "StreamingDataset",
    "load_batches",
    "RFIMaskDataset",
]
