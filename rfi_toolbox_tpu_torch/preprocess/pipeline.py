"""Waterfall -> patch preprocessing in plain PyTorch.

Counterpart of ``rfi_toolbox_tpu/preprocess/pipeline.py``: patchify
(of one 2-D array, and batched)/unpatchify, the rotation augmentation,
the 3-channel extraction and its variant-aware five-plane form, the
ImageNet affine, the per-patch MAD flags, the static on-device patch
selection, and the real-input median normalisation and stretch. ``extract_channels``,
``extract_channel_planes`` and ``mad_flag_patches`` are the plain
versions of the CUDA kernels in :mod:`rfi_toolbox_tpu_torch.ops` (K4,
K2 and K5); the kernels are held against these functions on the card,
and the CPU tests hold these functions against the JAX package.

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

from ..utils.profiling import span

__all__ = [
    "patchify",
    "patchify_batch",
    "unpatchify_batch",
    "apply_rotations",
    "magnitude",
    "extract_channels",
    "extract_channel_planes",
    "imagenet_normalize",
    "mad_flag_patches",
    "static_select_flagged",
    "static_select_from_has",
    "static_select_kept",
    "normalize_by_median",
    "apply_stretch",
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


def patchify(array, patch_shape, step):
    """2-D array -> (n_h, n_w, patch_h, patch_w) grid of patches taken
    every ``step`` rows and columns (the reference's ``torch.unfold``
    helper); a tensor on the array's device, or on the CPU for numpy
    input. Non-overlapping steps are a reshape and a permute, overlapping
    ones a gather of strided windows."""
    patch_h, patch_w = patch_shape
    array = torch.as_tensor(array)
    h, w = array.shape
    n_h = (h - patch_h) // step + 1
    n_w = (w - patch_w) // step + 1
    if step == patch_h == patch_w:
        trimmed = array[:n_h * patch_h, :n_w * patch_w]
        return trimmed.reshape(n_h, patch_h, n_w, patch_w).permute(0, 2, 1, 3)
    dev = array.device
    rows = (torch.arange(n_h, device=dev) * step)[:, None] + torch.arange(patch_h, device=dev)
    cols = (torch.arange(n_w, device=dev) * step)[:, None] + torch.arange(patch_w, device=dev)
    return array[rows[:, None, :, None], cols[None, :, None, :]]


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


def apply_rotations(data, num_rotations):
    """The reference's 4-way "rotation" augmentation of (B, H, W)
    waterfalls: identity, flipud, transpose, flipud of the transpose
    (not true 90-degree rotations).

    Returns ``(group_a, group_b)``: ``group_a`` (B, r_a, H, W) holds
    [orig(, flipud)] with r_a = 1 or 2; ``group_b`` (B, 2, W, H) holds
    [T, flipud(T)] when ``num_rotations == 4``, else None.
    """
    if num_rotations not in (1, 2, 4):
        raise ValueError(f"num_rotations must be 1, 2, or 4, got {num_rotations}")
    variants_a = [data]
    if num_rotations >= 2:
        variants_a.append(data.flip(-2))
    group_a = torch.stack(variants_a, dim=1)
    group_b = None
    if num_rotations == 4:
        t = data.transpose(-1, -2)
        group_b = torch.stack([t, t.flip(-2)], dim=1)
    return group_a, group_b


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


def extract_channel_planes(patches):
    """Everything :func:`extract_channels` needs for the four rotation
    variants of (N, H, W) base patches, ImageNet-normalised.

    Only the gradient's zeroed edge depends on the variant, so three
    gradient planes cover all four: ``grad3[0]`` zeroes the first row
    and column (variants orig and T), ``grad3[1]`` the last row and the
    first column (flipud), ``grad3[2]`` the first row and the last column
    (flipud of T). Returns ``(grad3 (3, N, H, W), log_amp (N, H, W),
    phase (N, H, W))`` float32; real input gets the min-max log-amplitude
    and zero phase of :func:`extract_channels`.
    """
    log_amp = torch.log10(magnitude(patches) + 1e-10)
    d_t = log_amp[:, 1:, :] - log_amp[:, :-1, :]
    d_f = log_amp[:, :, 1:] - log_amp[:, :, :-1]
    td_fwd = torch.nn.functional.pad(d_t, (0, 0, 1, 0))
    td_down = torch.nn.functional.pad(d_t, (0, 0, 0, 1))
    fd_fwd = torch.nn.functional.pad(d_f, (1, 0))
    fd_down = torch.nn.functional.pad(d_f, (0, 1))
    grad3 = torch.stack([
        torch.sqrt(td_fwd * td_fwd + fd_fwd * fd_fwd),
        torch.sqrt(td_down * td_down + fd_fwd * fd_fwd),
        torch.sqrt(td_fwd * td_fwd + fd_down * fd_down),
    ])
    grad3 = _nanminmax_normalize(grad3)
    if patches.is_complex():
        log_norm = torch.clamp((log_amp - LOG_MIN) / (LOG_MAX - LOG_MIN), 0.0, 1.0)
        phase = torch.atan2(patches.imag, patches.real).to(torch.float32)
        phase_norm = (phase + np.pi) / (2.0 * np.pi)
    else:
        log_norm = _nanminmax_normalize(log_amp)
        phase_norm = torch.zeros_like(log_amp)
    mean, std = IMAGENET_MEAN, IMAGENET_STD
    return ((grad3 - float(mean[0])) / float(std[0]),
            (log_norm - float(mean[1])) / float(std[1]),
            (phase_norm - float(mean[2])) / float(std[2]))


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


def static_select_kept(has, k):
    """The deterministic part of :func:`static_select_from_has`: (k,)
    int64 indices into ``has`` (an (N,) bool any-flag vector), flagged
    patches first in their order, repeated cyclically to fill ``k`` and
    truncated past it; all N patches cycle when none is flagged. Runs on
    the tensor's device without a host sync."""
    n = has.shape[0]
    order = torch.argsort((~has).to(torch.int8), stable=True)
    n_f = has.sum()
    denom = torch.where(n_f > 0, n_f, n).clamp(min=1)
    return order[torch.arange(k, device=has.device) % denom]


def static_select_from_has(has, k, generator):
    """Static-count selection over an (N,) bool any-flag vector: the
    indices of :func:`static_select_kept`, shuffled by
    ``torch.randperm`` drawn from ``generator`` (a ``torch.Generator`` on
    the device of ``has``). JAX's ``jax.random.permutation`` stream
    cannot be reproduced, so only the kept multiset matches the
    reference. In the ``prep.select`` span."""
    with span("prep.select"):
        kept = static_select_kept(has, k)
        perm = torch.randperm(k, generator=generator, device=has.device)
        return kept[perm]


def static_select_flagged(flag_patches, k, generator):
    """:func:`static_select_from_has` over the any-flag vector of
    (N, ...) flag patches."""
    has = flag_patches.reshape(flag_patches.shape[0], -1).any(dim=1)
    return static_select_from_has(has, k, generator)


def normalize_by_median(patches):
    """Divide each patch by its NaN-omitting median where that median is
    positive; complex input by magnitude first."""
    mag = magnitude(patches) if patches.is_complex() else patches
    med = _nanmedian_rows(mag.reshape(mag.shape[0], -1)).reshape(-1, 1, 1)
    pos = med > 0
    return torch.where(pos, mag / torch.where(pos, med, 1.0), mag)


def apply_stretch(patches, stretch):
    """SQRT or LOG10 stretch of |patches|; infinities are replaced by the
    per-patch MAD of the finite values (0 where none is finite)."""
    mag = magnitude(patches) if patches.is_complex() else patches.abs().float()
    if stretch == "SQRT":
        out = torch.sqrt(mag)
    elif stretch == "LOG10":
        out = torch.log10(mag)
    else:
        raise ValueError(f"Invalid stretch '{stretch}'. Use 'SQRT' or 'LOG10'")
    flat = out.reshape(out.shape[0], -1)
    finite = torch.isfinite(flat)
    count = finite.sum(dim=1, keepdim=True)
    safe = count.clamp(min=1)
    idx_lo = ((safe - 1) // 2).clamp(min=0)
    idx_hi = safe // 2

    def _mid(values):
        ordered = torch.sort(values, dim=1).values
        return 0.5 * (ordered.gather(1, idx_lo) + ordered.gather(1, idx_hi))

    inf = torch.tensor(float("inf"), device=flat.device)
    med = _mid(torch.where(finite, flat, inf))
    mad = _mid(torch.where(finite, (flat - med).abs(), inf))
    fill = torch.where(count > 0, mad, 0.0)
    return torch.where(torch.isinf(flat), fill, flat).reshape(out.shape)
