"""In-memory dataset of (image, label) pairs.

Counterpart of ``rfi_toolbox_tpu/data/batched_dataset.py:ArrayDataset``,
the container that ``Preprocessor.create_dataset`` returns. Tensors stay
on their device; anything else becomes a numpy array. The on-disk
writers and readers of that module are not ported yet.
"""

import numpy as np

__all__ = ["ArrayDataset"]


class ArrayDataset:
    """Images (N, H, W, 3) float32 and labels (N, H, W) uint8, with a
    metadata dict."""

    def __init__(self, images, labels, metadata=None):
        if not hasattr(images, "ndim"):
            images = np.asarray(images)
        if not hasattr(labels, "ndim"):
            labels = np.asarray(labels)
        if len(images) != len(labels):
            raise ValueError("Images and labels must have same length")
        self.images = images
        self.labels = labels
        self.metadata = metadata or {}

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return {"image": self.images[idx], "label": self.labels[idx]}

    def __repr__(self):
        return (f"ArrayDataset(n={len(self)}, images={tuple(self.images.shape)}, "
                f"labels={tuple(self.labels.shape)})")
