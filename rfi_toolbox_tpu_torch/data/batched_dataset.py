"""In-memory dataset of (image, label) pairs.

Counterpart of ``rfi_toolbox_tpu/data/batched_dataset.py:ArrayDataset``
(and its alias ``TorchDataset``), the container that
``Preprocessor.create_dataset`` returns. Tensors stay on their device;
anything else becomes a numpy array. ``save_to_disk`` and
``load_from_disk`` use the JAX package's single-file ``.npz`` format
(arrays ``images``, ``labels`` and the JSON string ``metadata``), so
either package reads what the other wrote. The batch-file writer and
streaming reader (``BatchWriter``, ``StreamingDataset``) are not ported
yet.
"""

import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["ArrayDataset", "TorchDataset"]


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


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

    def save_to_disk(self, path):
        """Write one ``.npz`` file (images, labels, JSON metadata); tensors
        are copied to the host. Returns the path."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, images=_numpy(self.images), labels=_numpy(self.labels),
                 metadata=json.dumps(self.metadata, default=str))
        return path

    @classmethod
    def load_from_disk(cls, path):
        """Read a ``.npz`` written by either package's ``save_to_disk``;
        the arrays come back as numpy."""
        with np.load(path, allow_pickle=False) as data:
            metadata = json.loads(str(data["metadata"])) if "metadata" in data else {}
            return cls(data["images"], data["labels"], metadata)

    def __repr__(self):
        return (f"ArrayDataset(n={len(self)}, images={tuple(self.images.shape)}, "
                f"labels={tuple(self.labels.shape)})")


# the reference's name for the same container
TorchDataset = ArrayDataset
