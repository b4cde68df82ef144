"""Waterfall flagging on the card.

Counterpart of ``rfi_toolbox_tpu/io/flagging.py``:

- ``flag_waterfalls`` (``method="mad"`` and ``method="model"``): patchify
  -> MAD flags (kernel K5) or 3-channel extraction (kernel K4) and a
  predictor -> unpatchify;
- ``flag_waterfalls_coherent``: the coherent 8-channel convention, all
  four polarisations of a baseline through one 8-channel model, one mask
  a baseline.

The mesh-sharded path and ``flag_measurement_set`` are not ported yet.
"""

import torch

from ..ops import fused_extract_channels, mad_flag_patches
from ..preprocess import pipeline as P
from ..train.coherent_trainer import robust_scale, to_8ch
from ..utils.device import resolve_device

__all__ = ["flag_waterfalls", "flag_waterfalls_coherent"]


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


def flag_waterfalls_coherent(vis4, predictor, patch_size=128, threshold=0.5,
                             device=None):
    """Flag (B, 4, C, T) 4-pol complex waterfalls with an 8-channel
    coherent model (``pretrained/unet*_coherent8ch.npz``).

    Each baseline's four polarisations are patchified together into
    4 pols x (re, im) = 8-channel patches, each robust-scaled on its own
    (median and interquartile range over its 8 channels; the zero padding
    of edge patches is left out of the statistics), flagged by the
    predictor and put back together: one (C, T) mask a baseline, shared
    by its four polarisations.

    Args:
        vis4: (B, 4, C, T) complex numpy array or tensor.
        predictor: callable (N, p, p, 8) float32 tensor -> (N, p, p) bool
            or probabilities (cut at ``threshold``), e.g.
            ``CompiledPredictor.from_snapshot("pretrained/unet24gn_coherent8ch.npz")``.
        device: ``None`` for the CUDA card, or e.g. ``"cpu"``.

    Returns:
        (B, C, T) bool tensor on the device.
    """
    dev = resolve_device(device)
    vis4 = torch.as_tensor(vis4).to(device=dev, dtype=torch.complex64)
    if vis4.ndim != 4 or vis4.shape[1] != 4:
        raise ValueError(f"Expected (B, 4, C, T) 4-pol waterfalls, got {tuple(vis4.shape)}")
    b, _, c, t = vis4.shape
    preds = torch.as_tensor(predictor(coherent_images(vis4, patch_size)), device=dev)
    preds = preds if preds.dtype == torch.bool else preds > threshold
    return P.unpatchify_batch(preds, b, c, t)


def coherent_images(vis4, patch_size):
    """(B, 4, C, T) complex64 -> (B * N, p, p, 8) float32 robust-scaled
    patches, N patches a plane in ``patchify_batch``'s order
    (flagging.py:184-222)."""
    b, _, c, t = vis4.shape
    p = patch_size
    patches = P.patchify_batch(vis4.reshape(b * 4, c, t), p)  # (b * 4 * N, p, p)
    n = patches.shape[0] // (b * 4)
    x = to_8ch(patches.reshape(b, 4, n, p, p).transpose(1, 2)).reshape(b * n, p, p, 8)
    valid = None
    if c % p or t % p:
        # edge patches hold patchify's zero padding; it stays out of the
        # median and the quartiles (q25 would pin to 0 past 25% padding)
        ones = torch.ones((1, c, t), device=vis4.device)
        valid = (P.patchify_batch(ones, p) > 0).repeat(b, 1, 1)[..., None]
    return robust_scale(x, valid)
