"""Segmentation losses.

Counterpart of ``rfi_toolbox_tpu/train/losses.py``: BCE-with-logits plus
soft Dice with smooth 1, computed in float32 whatever the logits' dtype.

With a process group (``group``: the ranks that each hold some rows of
one batch), each rank sums its rows and the sums are all-reduced before
the loss is formed, so that every rank computes the loss of the whole
batch, as JAX computes it over a batch sharded on a mesh. The
all-reduce's backward is the identity
(:func:`~rfi_toolbox_tpu_torch.parallel.functional.all_reduce_partial`):
each rank's gradient is then its rows' share, and the ranks' gradients
sum to the batch's.
"""

import torch

from ..parallel.functional import all_reduce_partial, group_size

__all__ = ["bce_with_logits_loss", "dice_loss", "bce_dice_loss"]


def bce_with_logits_loss(logits, targets, group=None):
    """Mean binary cross-entropy on logits, in the stable form
    ``max(x, 0) - x*y + log1p(exp(-|x|))``; over the rows of all of
    ``group``'s ranks when given."""
    x = logits.to(torch.float32)
    y = targets.to(torch.float32)
    terms = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    if group is None:
        return terms.mean()
    return all_reduce_partial(terms.sum(), group) / (terms.numel() * group_size(group))


def dice_loss(logits, targets, smooth=1.0, group=None):
    """``1 - (2 * intersection + smooth) / (|p| + |t| + smooth)`` over the
    flattened batch (all of ``group``'s rows when given)."""
    p = torch.sigmoid(logits.to(torch.float32)).reshape(-1)
    t = targets.to(torch.float32).reshape(-1)
    if group is None:
        return 1.0 - (2.0 * (p * t).sum() + smooth) / (p.sum() + t.sum() + smooth)
    inter, p_sum, t_sum = all_reduce_partial(
        torch.stack([(p * t).sum(), p.sum(), t.sum()]), group)
    return 1.0 - (2.0 * inter + smooth) / (p_sum + t_sum + smooth)


def bce_dice_loss(logits, targets, smooth=1.0, group=None):
    """The reference's training loss: BCE-with-logits + Dice (smooth 1)."""
    return (bce_with_logits_loss(logits, targets, group)
            + dice_loss(logits, targets, smooth, group))
