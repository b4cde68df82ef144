"""Waterfall -> patch preprocessing in plain PyTorch.

Counterpart of ``rfi_toolbox_tpu/preprocess/pipeline.py`` for the
flagging slice: patchify/unpatchify, the 3-channel extraction with its
ImageNet affine, and the per-patch MAD flags. The last two are the
plain versions of the CUDA kernels in :mod:`rfi_toolbox_tpu_torch.ops`
(K4 ``fused_extract_channels`` and K5 ``mad_flag_patches``); the kernels
are held against these functions on the card, and the CPU tests hold
these functions against the JAX package.

Numerics follow the JAX reference on the CPU exactly where it matters
for exact outputs (the MAD flags):

- complex magnitude is ``max(|re|, |im|) * sqrt(fma(r, r, 1))`` with
  ``r = min/max``, the scaled form XLA and numpy use; the square root
  is taken in float64 and rounded, because PyTorch's float32 CPU
  ``sqrt`` is not correctly rounded;
- the median of an even count is ``(lo + hi) * 0.5`` of the two middle
  order statistics, NaNs omitted (``jnp.nanmedian``, method midpoint);
- ``sigma`` is applied as a float32 scalar.
"""

import numpy as np
import torch

__all__ = [
    "patchify_batch",
    "unpatchify_batch",
    "magnitude",
    "extract_channels",
    "imagenet_normalize",
    "mad_flag_patches",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "LOG_MIN",
    "LOG_MAX",
]

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# Fixed physical log10-amplitude window: log10(1 mJy noise) .. log10(10^4 Jy)
LOG_MIN = -3.0
LOG_MAX = 4.0


def _pad_to_multiple(x, patch_size):
    """Zero-pad the trailing 2 dims up to multiples of patch_size (and at
    least patch_size)."""
    h, w = x.shape[-2], x.shape[-1]
    ph = (-h) % patch_size if h >= patch_size else patch_size - h
    pw = (-w) % patch_size if w >= patch_size else patch_size - w
    if ph == 0 and pw == 0:
        return x
    out = x.new_zeros((*x.shape[:-2], h + ph, w + pw))
    out[..., :h, :w] = x
    return out


def patchify_batch(waterfalls, patch_size):
    """(B, H, W) -> (B * n_h * n_w, patch, patch), zero-padded, patches
    row-major within each waterfall (channel blocks outer)."""
    x = _pad_to_multiple(waterfalls, patch_size)
    b, h, w = x.shape
    nh, nw = h // patch_size, w // patch_size
    x = x.reshape(b, nh, patch_size, nw, patch_size).permute(0, 1, 3, 2, 4)
    return x.reshape(b * nh * nw, patch_size, patch_size)


def unpatchify_batch(patches, num_waterfalls, height, width):
    """Inverse of :func:`patchify_batch`: (B*n_h*n_w, p, p) ->
    (B, height, width), cropping the zero padding."""
    p = patches.shape[-1]
    nh = -(-height // p)
    nw = -(-width // p)
    x = patches.reshape(num_waterfalls, nh, nw, p, p).permute(0, 1, 3, 2, 4)
    x = x.reshape(num_waterfalls, nh * p, nw * p)
    return x[:, :height, :width]


def magnitude(x):
    """|x| as float32; complex input uses the scaled hypot that the CUDA
    kernels compute bit for bit (see the module docstring)."""
    if not x.is_complex():
        return x.abs().to(torch.float32)
    a = x.real.abs()
    b = x.imag.abs()
    larger = torch.maximum(a, b)  # propagates NaN like the reference
    smaller = torch.minimum(a, b)
    ok = (larger != 0) & (smaller != float("inf"))
    ratio = torch.where(ok, smaller / torch.where(ok, larger, 1.0), 0.0)
    r = ratio.double()
    s = (r * r + 1.0).float()  # r*r is exact in float64: this is fma(r, r, 1)
    return torch.sqrt(s.double()).float() * larger


def _nanminmax_normalize(x):
    """Per-patch min-max normalisation over the trailing 2 dims, NaNs
    ignored; constant patches map to zeros."""
    nan = torch.isnan(x)
    lo = torch.where(nan, float("inf"), x).amin(dim=(-2, -1), keepdim=True)
    hi = torch.where(nan, float("-inf"), x).amax(dim=(-2, -1), keepdim=True)
    span = hi - lo
    pos = span > 0
    return torch.where(pos, (x - lo) / torch.where(pos, span, 1.0), 0.0)


def extract_channels(patches):
    """(N, H, W) -> (N, H, W, 3) float32 [gradient, log_amp, phase].

    Complex input: log_amp in the fixed window [LOG_MIN, LOG_MAX] and
    phase mapped to [0, 1]. Real input: min-max log_amp and a zero phase
    channel. The gradient is the magnitude of the forward differences of
    log10|x| (zero first row/column), min-max normalised per patch.
    """
    log_amp = torch.log10(magnitude(patches) + 1e-10)
    td = torch.zeros_like(log_amp)
    td[:, 1:, :] = log_amp[:, 1:, :] - log_amp[:, :-1, :]
    fd = torch.zeros_like(log_amp)
    fd[:, :, 1:] = log_amp[:, :, 1:] - log_amp[:, :, :-1]
    gradient_norm = _nanminmax_normalize(torch.sqrt(td * td + fd * fd))

    if patches.is_complex():
        log_amp_norm = torch.clamp((log_amp - LOG_MIN) / (LOG_MAX - LOG_MIN),
                                   0.0, 1.0)
        phase = torch.atan2(patches.imag, patches.real).to(torch.float32)
        phase_norm = (phase + np.pi) / (2.0 * np.pi)
    else:
        log_amp_norm = _nanminmax_normalize(log_amp)
        phase_norm = torch.zeros_like(log_amp)
    return torch.stack([gradient_norm, log_amp_norm, phase_norm], dim=-1)


def imagenet_normalize(images):
    """ImageNet per-channel normalisation of (..., 3) images."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    return (images - mean) / std


def _nanmedian_rows(flat):
    """Median of each row with NaNs omitted; the mean of the two middle
    order statistics for an even count, NaN for an all-NaN row."""
    ordered = torch.sort(flat, dim=1).values  # NaNs sort last
    count = (~torch.isnan(flat)).sum(dim=1, keepdim=True)
    lo = ordered.gather(1, ((count - 1) // 2).clamp(min=0))
    hi = ordered.gather(1, (count // 2).clamp(max=flat.shape[1] - 1))
    return (lo + hi) * 0.5


def mad_flag_patches(patches, sigma):
    """Per-patch two-sided MAD flags: (N, H, W) -> (N, H, W) bool.

    Complex input uses its magnitude. A pixel is flagged when
    ``|x - median| > sigma * MAD``, evaluated as ``x > median + MAD*sigma``
    or ``x < median - MAD*sigma`` in float32. NaNs are left out of the
    median and MAD and never flagged.
    """
    x = magnitude(patches) if patches.is_complex() else patches.float()
    flat = x.reshape(x.shape[0], -1)
    median = _nanmedian_rows(flat)
    mad = _nanmedian_rows((flat - median).abs())
    spread = mad * torch.tensor(sigma, dtype=flat.dtype, device=flat.device)
    flags = (flat > median + spread) | (flat < median - spread)
    return flags.reshape(x.shape)
