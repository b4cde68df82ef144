"""K5: per-patch MAD flags on the card.

Counterpart of ``rfi_toolbox_tpu/ops/mad_flags.py:
mad_flag_patches_pallas``. The kernel is ``csrc/mad_flags.cu``; its plain
version is the pipeline's :func:`mad_flag_patches`, which the wrapper
runs for a tensor on the CPU, and the kernel's flags are bit-equal to it.
On a CUDA tensor the wrapper launches the kernel or raises; nothing
falls back. Unlike the TPU kernel it takes any patch size in the kernel,
a whole 1024 x 1024 waterfall included, and negative real input.

``mad_flag_patches.launches`` counts the kernel's launches.
"""

import numpy as np
import torch

from ..preprocess.pipeline import mad_flag_patches as mad_flag_patches_plain
from . import _lib

__all__ = ["mad_flag_patches", "mad_flag_patches_plain"]

SHARED_KEYS = 128 * 128  # kSharedKeys in csrc/mad_flags.cu


def mad_flag_patches(patches, sigma):
    """(N, H, W) complex64 or float32 -> (N, H, W) bool: a pixel is
    flagged where ``|x - median| > sigma * MAD`` of its patch (complex
    input by magnitude); NaNs are omitted and never flagged.

    A CPU tensor goes through the plain version. A CUDA tensor must be
    contiguous complex64 or float32.
    """
    if patches.device.type == "cpu":
        return mad_flag_patches_plain(patches, sigma)
    if patches.device.type != "cuda":
        raise ValueError(f"unsupported device {patches.device}")
    if patches.dtype not in (torch.complex64, torch.float32):
        raise TypeError(f"expected complex64 or float32, got {patches.dtype}")
    if patches.ndim != 3:
        raise ValueError(f"expected (N, H, W) patches, got {tuple(patches.shape)}")
    if not patches.is_contiguous():
        raise ValueError("patches must be contiguous")
    n, h, w = patches.shape
    hw = h * w
    flags = torch.empty((n, h, w), dtype=torch.bool, device=patches.device)
    if n == 0 or hw == 0:
        return flags.zero_()
    scratch = None
    if hw > SHARED_KEYS:
        scratch = torch.empty((n, hw), dtype=torch.int32, device=patches.device)
    rc = _lib.load().rfi_mad_flag_patches(
        patches.data_ptr(), flags.data_ptr(),
        None if scratch is None else scratch.data_ptr(), n, hw,
        int(patches.is_complex()), float(np.float32(sigma)),
        _lib.stream_of(patches),
    )
    _lib.check(rc, "mad_flag_patches")
    mad_flag_patches.launches += 1
    return flags


mad_flag_patches.launches = 0
