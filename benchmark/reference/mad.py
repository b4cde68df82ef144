"""MAD flags, in plain PyTorch.

The published rule (``rfi_toolbox_tpu/preprocess/pipeline.py``): within
each patch, by magnitude, a pixel is flagged where ``x > median +
MAD * sigma`` or ``x < median - MAD * sigma`` in float32, the median of
an even count being the mean of its two middle values and NaNs left out.
"""

import torch

from .extract import magnitude, patchify, unpatchify


def _median_rows(x):
    ordered = torch.sort(x, dim=1).values  # NaNs sort last
    n = (~torch.isnan(x)).sum(dim=1, keepdim=True)
    lo = ordered.gather(1, ((n - 1) // 2).clamp(min=0))
    hi = ordered.gather(1, (n // 2).clamp(max=x.shape[1] - 1))
    return (lo + hi) * 0.5


def patch_flags(patches, sigma, q=None):
    """(N, p, p) -> (N, p, p) bool MAD flags; ``q`` rounds the
    magnitudes (the control)."""
    x = magnitude(patches)
    if q is not None:
        x = q(x)
    flat = x.reshape(x.shape[0], -1)
    med = _median_rows(flat)
    spread = _median_rows((flat - med).abs()) * torch.tensor(sigma, dtype=torch.float32)
    return ((flat > med + spread) | (flat < med - spread)).reshape(x.shape)


def waterfall_flags(waterfalls, sigma, patch, q=None, rows=512):
    """(B, C, T) waterfalls (C and T multiples of ``patch``) -> (B, C, T)
    flags, computed ``rows`` patches at a time."""
    b, c, t = waterfalls.shape
    patches = patchify(waterfalls, patch)
    flags = torch.cat([patch_flags(patches[i:i + rows], sigma, q)
                       for i in range(0, patches.shape[0], rows)])
    return unpatchify(flags, b, c, t)
