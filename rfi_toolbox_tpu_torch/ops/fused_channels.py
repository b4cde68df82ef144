"""K4: fused 3-channel extraction on the card.

Counterpart of ``rfi_toolbox_tpu/ops/fused_channels.py:
fused_extract_channels``. The kernel is ``csrc/fused_channels.cu``; its
plain version is :func:`fused_extract_channels_plain` (the pipeline's
``imagenet_normalize(extract_channels(x))``), which the wrapper runs for
a tensor on the CPU. On a CUDA tensor the wrapper launches the kernel or
raises; nothing falls back.

``fused_extract_channels.launches`` counts the kernel's launches.
"""

import torch

from ..preprocess import pipeline as P
from . import _lib

__all__ = ["fused_extract_channels", "fused_extract_channels_plain",
           "MAX_PATCH_PIXELS"]

MAX_PATCH_PIXELS = 128 * 128  # kMaxPixels in csrc/fused_channels.cu


def fused_extract_channels_plain(patches):
    """Plain PyTorch version of the kernel, on any device."""
    return P.imagenet_normalize(P.extract_channels(patches))


def fused_extract_channels(patches):
    """(N, H, W) complex64 or float32 -> (N, H, W, 3) float32,
    ImageNet-normalised [gradient, log_amp, phase].

    A CPU tensor goes through the plain version. A CUDA tensor must be
    contiguous complex64 or float32 with H * W <= 128 * 128.
    """
    if patches.device.type == "cpu":
        return fused_extract_channels_plain(patches)
    if patches.device.type != "cuda":
        raise ValueError(f"unsupported device {patches.device}")
    if patches.dtype not in (torch.complex64, torch.float32):
        raise TypeError(f"expected complex64 or float32, got {patches.dtype}")
    if patches.ndim != 3:
        raise ValueError(f"expected (N, H, W) patches, got {tuple(patches.shape)}")
    if not patches.is_contiguous():
        raise ValueError("patches must be contiguous")
    n, h, w = patches.shape
    if h * w > MAX_PATCH_PIXELS:
        raise ValueError(
            f"the extraction kernel takes patches of at most "
            f"{MAX_PATCH_PIXELS} pixels (128 x 128), got {h} x {w}"
        )
    out = torch.empty((n, h, w, 3), dtype=torch.float32, device=patches.device)
    if n == 0:
        return out
    rc = _lib.load().rfi_fused_extract_channels(
        patches.data_ptr(), out.data_ptr(), n, h, w,
        int(patches.is_complex()), _lib.stream_of(patches),
    )
    _lib.check(rc, "fused_extract_channels")
    fused_extract_channels.launches += 1
    return out


fused_extract_channels.launches = 0
