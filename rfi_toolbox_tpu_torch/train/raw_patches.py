"""Training on the card from raw complex patches.

Counterpart of ``rfi_toolbox_tpu/train/raw_patches.py``: training takes
the raw patches of :class:`~rfi_toolbox_tpu_torch.preprocess.DevicePreprocessor`
and runs every per-step transform on the device: a random member of the
{id, flipud, T, flipud.T} group for each sample, the 3-channel extraction
and the ImageNet affine (K4, ``ops.fused_extract_channels``, on the card;
its plain version on the CPU). That stores half the bytes of 3-channel
float32 images, makes no 4x augmentation copy, and draws a new
augmentation every epoch.

The augmentation is drawn from an explicit ``torch.Generator`` on the
device; its stream is not ``jax.random``'s, so the tests hand the JAX
draw across to compare a step.
"""

import numpy as np
import torch

from .. import ops
from ..preprocess.static_prep import transform_by_variant
from ..utils.device import resolve_device
from .trainer import create_train_state, train_step

__all__ = ["augment_batch", "make_raw_patch_step", "RawPatchTrainer"]


def augment_batch(generator, patches, masks):
    """Each sample of square (N, p, p) patches and its mask through one
    member of {id, flipud, T, flipud(T)} (variants 0-3 of
    :func:`~rfi_toolbox_tpu_torch.preprocess.static_prep.transform_by_variant`),
    drawn uniformly per sample from ``generator`` (on the patches'
    device). Returns ``(patches, masks)``."""
    choice = torch.randint(0, 4, (patches.shape[0],), generator=generator,
                           device=patches.device)
    return transform_by_variant(patches, choice), transform_by_variant(masks, choice)


def make_raw_patch_step(train_step, use_kernels=True):
    """Wrap a ``(state, images, labels)`` train step into a raw-patch step
    ``(state, generator, patches, masks) -> (state, loss)``: the
    augmentation, then the extraction (K4 with ``use_kernels``, which on
    a CPU tensor is its plain version; False runs the plain version on
    the card too), then the step on float32 masks."""
    extract = ops.fused_extract_channels if use_kernels else ops.fused_extract_channels_plain

    def step(state, generator, patches, masks):
        patches, masks = augment_batch(generator, patches, masks)
        images = extract(patches.contiguous())
        return train_step(state, images, masks.to(torch.float32))

    return step


class RawPatchTrainer:
    """Trainer over raw complex patches (``DevicePreprocessor`` output).

    >>> raw, masks = DevicePreprocessor(vis, flags).create_raw_patches()
    >>> trainer = RawPatchTrainer(model)
    >>> result = trainer.fit(raw, masks, num_epochs=10, batch_size=32)

    Args:
        model: the port's UNet.
        learning_rate, weight_decay: AdamW's (the JAX defaults).
        seed: seeds Flax's initialisers for a fresh state, the batch order
            (``np.random.default_rng(seed)``, the JAX order) and the
            augmentation's generator (``seed + 1``).
        use_kernels: extract with K4 on the card (see
            :func:`make_raw_patch_step`).
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.
    """

    def __init__(self, model, learning_rate=1e-4, weight_decay=1e-5, seed=0,
                 use_kernels=True, device=None):
        self.model = model
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.seed = seed
        self.device = resolve_device(device)
        self._step = make_raw_patch_step(train_step, use_kernels)
        self.state = None

    def fit(self, raw_patches, masks, num_epochs=10, batch_size=32):
        """Train; returns ``{'history': [...]}`` with each epoch's mean
        loss. Each epoch takes ``max(N // batch_size, 1)`` steps over a
        permutation of the patches."""
        patches = torch.as_tensor(raw_patches).to(self.device)
        masks = torch.as_tensor(masks).to(self.device, torch.float32)
        n = patches.shape[0]
        if self.state is None:
            self.state = create_train_state(self.model, self.seed, self.learning_rate,
                                            self.weight_decay, device=self.device)
        rng = np.random.default_rng(self.seed)
        generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        history = []
        steps = max(n // batch_size, 1)
        for epoch in range(num_epochs):
            perm = rng.permutation(n)
            losses = []
            for s in range(steps):
                idx = torch.as_tensor(perm[s * batch_size:(s + 1) * batch_size],
                                      device=self.device)
                self.state, loss = self._step(self.state, generator, patches[idx],
                                              masks[idx])
                losses.append(loss)
            history.append({"epoch": epoch + 1,
                            "train_loss": float(torch.stack(losses).mean())})
        return {"history": history}
