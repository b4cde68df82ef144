"""Waterfall flagging on the card.

Counterpart of ``rfi_toolbox_tpu/io/flagging.py:flag_waterfalls`` for
``method="mad"`` and ``method="model"``: patchify -> MAD flags (kernel K5)
or 3-channel extraction (kernel K4) and a predictor -> unpatchify. The
mesh-sharded path and the coherent 8-channel path are not ported yet.
"""

import torch

from ..ops import fused_extract_channels, mad_flag_patches
from ..preprocess import pipeline as P
from ..utils.device import resolve_device

__all__ = ["flag_waterfalls"]


def _as_waterfalls(waterfalls, device):
    """(M, C, T) array or tensor -> complex64 or float32 tensor on device
    (the reference's dtypes with 64-bit types disabled)."""
    x = torch.as_tensor(waterfalls)
    dtype = torch.complex64 if x.is_complex() else torch.float32
    x = x.to(device=device, dtype=dtype)
    if x.ndim != 3:
        raise ValueError(f"Expected (M, C, T) waterfalls, got {tuple(x.shape)}")
    return x.contiguous()


def flag_waterfalls(waterfalls, method="mad", sigma=5.0, patch_size=128,
                    predictor=None, threshold=0.5, device=None):
    """Flag a batch of waterfalls.

    Args:
        waterfalls: (M, C, T) complex or real numpy array or tensor.
        method: ``"mad"`` (per-patch MAD threshold at ``sigma``) or
            ``"model"``.
        patch_size: side of the square patches; a waterfall no larger
            than one patch is flagged as a single patch of its own shape.
        predictor: for ``method="model"``, a callable (N, p, p, 3) float32
            tensor -> (N, p, p) bool or probabilities (cut at
            ``threshold``), e.g. :class:`~rfi_toolbox_tpu_torch.serving.CompiledPredictor`.
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.

    Returns:
        (M, C, T) bool tensor on the device.
    """
    dev = resolve_device(device)
    flat = _as_waterfalls(waterfalls, dev)
    m, c, t = flat.shape
    patched = not (c <= patch_size and t <= patch_size)
    patches = P.patchify_batch(flat, patch_size).contiguous() if patched else flat

    if method == "mad":
        flags = mad_flag_patches(patches, sigma)
    elif method == "model":
        if predictor is None:
            raise ValueError("method='model' requires a predictor")
        preds = torch.as_tensor(predictor(fused_extract_channels(patches)),
                                device=dev)
        flags = preds if preds.dtype == torch.bool else preds > threshold
    else:
        raise ValueError(f"Unknown method '{method}' (use 'mad' or 'model')")

    if patched:
        flags = P.unpatchify_batch(flags, m, c, t)
    return flags
