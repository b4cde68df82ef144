"""Dataset containers and on-disk batch storage (``RFIMaskDataset`` waits
for the port of the measurement-set reader)."""

from .batched_dataset import (
    ArrayDataset,
    BatchWriter,
    StreamingDataset,
    TorchDataset,
    load_batches,
)

__all__ = [
    "ArrayDataset",
    "TorchDataset",
    "BatchWriter",
    "StreamingDataset",
    "load_batches",
]
