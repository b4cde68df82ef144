"""Segmentation losses.

Counterpart of ``rfi_toolbox_tpu/train/losses.py``: BCE-with-logits plus
soft Dice with smooth 1, computed in float32 whatever the logits' dtype.
"""

import torch

__all__ = ["bce_with_logits_loss", "dice_loss", "bce_dice_loss"]


def bce_with_logits_loss(logits, targets):
    """Mean binary cross-entropy on logits, in the stable form
    ``max(x, 0) - x*y + log1p(exp(-|x|))``."""
    x = logits.to(torch.float32)
    y = targets.to(torch.float32)
    return (x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))).mean()


def dice_loss(logits, targets, smooth=1.0):
    """``1 - (2 * intersection + smooth) / (|p| + |t| + smooth)`` over the
    flattened batch."""
    p = torch.sigmoid(logits.to(torch.float32)).reshape(-1)
    t = targets.to(torch.float32).reshape(-1)
    return 1.0 - (2.0 * (p * t).sum() + smooth) / (p.sum() + t.sum() + smooth)


def bce_dice_loss(logits, targets, smooth=1.0):
    """The reference's training loss: BCE-with-logits + Dice (smooth 1)."""
    return bce_with_logits_loss(logits, targets) + dice_loss(logits, targets, smooth)
