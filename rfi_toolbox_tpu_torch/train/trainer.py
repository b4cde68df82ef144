"""Training steps on the card: the loss, clip-by-global-norm and AdamW.

Counterpart of ``rfi_toolbox_tpu/train/trainer.py`` (``create_train_state``,
``train_step``, ``train_steps``, ``eval_step``; ``Trainer.fit``, its
checkpoints, ``predict`` and ``export_params`` are not ported yet).

The optimiser is optax's ``chain(clip_by_global_norm(1.0),
adamw(1e-4, weight_decay=1e-5))``, written out so that its numbers
follow optax and not ``torch.optim``:

- the gradients are scaled by ``max_norm / norm`` only where the global
  norm is not below ``max_norm``, with no epsilon (``clip_grad_norm_``
  adds 1e-6);
- Adam with b1 0.9, b2 0.999 and eps 1e-8 added outside the square root
  of the bias-corrected second moment;
- decoupled weight decay on the parameters before the update, scaled by
  the learning rate with the Adam step.

Images are NHWC (N, H, W, 3), labels (N, H, W). The model's conv
kernels and its activations are kept in the channels-last layout
(NHWC in memory, as the JAX package lays them out): cuDNN then runs its
NHWC kernels without transposes, and BatchNorm its channels-last
kernels. BatchNorm running statistics update in the forward of each
training step, as Flax's mutable ``batch_stats`` do.
"""

import torch

from ..models.unet import flax_init_
from ..utils.device import resolve_device
from .losses import bce_dice_loss

__all__ = ["TrainState", "create_train_state", "train_step", "train_steps",
           "eval_step"]

B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


class TrainState:
    """A model being trained and its optimiser state.

    Attributes:
        model: the UNet, on the training device.
        params: its parameters, in ``model.parameters()`` order.
        mu, nu: Adam's first and second moments, one tensor per parameter.
        step: optimiser steps taken (a host int; no device sync).
        learning_rate, weight_decay, clip_norm: the optimiser's settings.
    """

    def __init__(self, model, learning_rate=1e-4, weight_decay=1e-5,
                 clip_norm=1.0):
        self.model = model
        self.params = list(model.parameters())
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.step = 0
        self.learning_rate = float(learning_rate)
        self.weight_decay = float(weight_decay)
        self.clip_norm = float(clip_norm)

    @property
    def device(self):
        return self.params[0].device

    @torch.no_grad()
    def apply_gradients(self, grads):
        """One optimiser step, in place, without a host sync."""
        self.step += 1
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
        grads = torch._foreach_mul(grads, factor)
        torch._foreach_mul_(self.mu, B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - B1)
        torch._foreach_mul_(self.nu, B2)
        torch._foreach_add_(self.nu, torch._foreach_mul(grads, grads),
                            alpha=1.0 - B2)
        mu_hat = torch._foreach_div(self.mu, 1.0 - B1 ** self.step)
        denom = torch._foreach_div(self.nu, 1.0 - B2 ** self.step)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        update = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-self.learning_rate)


def create_train_state(model, seed=0, learning_rate=1e-4, weight_decay=1e-5,
                       clip_norm=1.0, device=None):
    """Put ``model`` on the device and pair it with a fresh optimiser.

    Args:
        model: the port's UNet.
        seed: int seed for Flax's initialisers (:func:`flax_init_`), or
            None to keep the model's weights (e.g. converted from a Flax
            state by ``models.params_from_flax``).
        learning_rate, weight_decay, clip_norm: the JAX defaults.
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.
    """
    dev = resolve_device(device)
    if seed is not None:
        at = next(model.parameters()).device
        flax_init_(model, torch.Generator(device=at).manual_seed(int(seed)))
    model = model.to(dev, memory_format=torch.channels_last)
    return TrainState(model, learning_rate, weight_decay, clip_norm)


def _logits(model, images):
    """(N, H, W, C) images -> (N, H, W) logits; the NCHW view of the
    images is made channels-last contiguous (a no-op for contiguous
    NHWC images)."""
    x = images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return model(x)[:, 0]


def train_step(state, images, labels):
    """One optimisation step on (B, H, W, 3) images and (B, H, W) labels.
    Updates ``state`` in place and returns ``(state, loss)``, the loss a
    0-d float32 tensor on the device (read it when needed: reading it
    waits for the card)."""
    state.model.train()
    loss = bce_dice_loss(_logits(state.model, images), labels)
    grads = torch.autograd.grad(loss, state.params)
    state.apply_gradients(list(grads))
    return state, loss.detach()


def train_steps(state, images, labels):
    """S optimisation steps on images (S, B, H, W, 3) and labels
    (S, B, H, W); the same numbers as S :func:`train_step` calls.
    Returns ``(state, losses)`` with losses (S,) on the device."""
    losses = [train_step(state, images[s], labels[s])[1]
              for s in range(images.shape[0])]
    return state, torch.stack(losses)


@torch.no_grad()
def eval_step(state, images, labels):
    """Loss and ``sigmoid(logits) > 0.5`` masks with the running
    statistics (eval mode)."""
    state.model.eval()
    logits = _logits(state.model, images)
    return bce_dice_loss(logits, labels), torch.sigmoid(logits) > 0.5
