"""Fold eval-mode BatchNorm into the preceding conv (inference only).

Counterpart of ``rfi_toolbox_tpu/models/folding.py``. In eval mode
BatchNorm is the affine map ``(conv(x) - mean) / sqrt(var + eps) * scale
+ bias``, which folds into the conv:

    weight' = weight * s          (s = scale / sqrt(var + eps), per C_out)
    bias'   = bias - mean * s     (+ conv_bias * s where the conv had one)

The folded model is the same UNet with ``norm="none"``: no normalise
passes in the forward. GroupNorm computes per-sample statistics and
cannot be folded. Logits match the unfolded model to float rounding.
"""

import torch

from .unet import BATCH_NORM_EPS, UNet

__all__ = ["fold_batchnorm"]


@torch.no_grad()
def fold_batchnorm(model):
    """Return a new ``norm="none"`` UNet with every BatchNorm of ``model``
    (a ``norm="batch"`` UNet) folded into its conv. ``model`` is left as
    it was. Raises ``ValueError`` for other norms."""
    if model.norm != "batch":
        raise ValueError(f"fold_batchnorm requires norm='batch', got {model.norm!r}")
    folded = UNet(**{**model.config(), "norm": "none"})
    src = model.state_dict()
    dst = {}
    for key in folded.state_dict():
        prefix, _, leaf = key.rpartition(".")
        bn = prefix.replace(".conv", ".norm")
        if bn == prefix or bn + ".running_var" not in src:
            dst[key] = src[key]  # up-convs and the head are not normalised
            continue
        s = src[bn + ".weight"] / torch.sqrt(src[bn + ".running_var"] + BATCH_NORM_EPS)
        if leaf == "weight":
            dst[key] = src[key] * s[:, None, None, None]
        else:  # the bias that norm="none" adds to each 3x3 conv
            dst[key] = src[bn + ".bias"] - src[bn + ".running_mean"] * s
    folded.load_state_dict(dst)
    return folded.to(next(model.parameters()).device).eval()
