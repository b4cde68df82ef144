"""Patches and their 3-channel images, in plain PyTorch.

The published extraction (``rfi_toolbox_tpu/preprocess/pipeline.py``):
for each patch, [gradient, log-amplitude, phase], where the
log-amplitude is ``log10(|x| + 1e-10)`` in the fixed window [-3, 4], the
phase ``atan2`` mapped to [0, 1], and the gradient the magnitude of the
forward differences of the log-amplitude (zero first row and column),
min-max normalised per patch; then the ImageNet affine. ``|x|`` of a
complex value is ``max(|re|, |im|) * sqrt(1 + r^2)`` with ``r = min/max``,
the scaled form of the published code, its products and square root in
float64 and rounded once.
"""

import math

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LOG_MIN, LOG_MAX = -3.0, 4.0


def _id(x):
    return x


def magnitude(x):
    """float32 |x| of complex64 (the scaled form) or real input."""
    if not x.is_complex():
        return x.abs().float()
    a, b = x.real.abs(), x.imag.abs()
    big, small = torch.maximum(a, b), torch.minimum(a, b)
    ok = (big != 0) & (small != math.inf)
    r = torch.where(ok, small / torch.where(ok, big, 1.0), 0.0).double()
    return torch.sqrt((r * r + 1.0).float().double()).float() * big


def patchify(x, p):
    """(B, H, W) with H, W multiples of ``p`` -> (B * H/p * W/p, p, p),
    patches row-major within each waterfall."""
    b, h, w = x.shape
    return (x.reshape(b, h // p, p, w // p, p).permute(0, 1, 3, 2, 4)
            .reshape(-1, p, p))


def unpatchify(patches, b, h, w):
    """Inverse of :func:`patchify`."""
    p = patches.shape[-1]
    return (patches.reshape(b, h // p, w // p, p, p).permute(0, 1, 3, 2, 4)
            .reshape(b, h, w))


def transform(x, v):
    """Variant ``v`` of square (K, p, p) patches: 0 as is, 1 rows
    flipped, 2 transposed, 3 transposed then rows flipped."""
    t = (v >= 2)[:, None, None]
    f = ((v == 1) | (v == 3))[:, None, None]
    x = torch.where(t, x.transpose(-1, -2), x)
    return torch.where(f, x.flip(-2), x)


def _minmax(x):
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    span = hi - lo
    return torch.where(span > 0, (x - lo) / torch.where(span > 0, span, 1.0), 0.0)


def images(patches, q=None):
    """(N, p, p) complex64 patches -> (N, p, p, 3) float32 images,
    ImageNet-normalised. ``q`` rounds the intermediates (the control)."""
    q = q or _id
    log_amp = q(torch.log10(q(magnitude(patches)) + 1e-10))
    td = torch.zeros_like(log_amp)
    td[:, 1:] = log_amp[:, 1:] - log_amp[:, :-1]
    fd = torch.zeros_like(log_amp)
    fd[:, :, 1:] = log_amp[:, :, 1:] - log_amp[:, :, :-1]
    grad = _minmax(q(torch.sqrt(td * td + fd * fd)))
    if patches.is_complex():
        amp = torch.clamp((log_amp - LOG_MIN) / (LOG_MAX - LOG_MIN), 0.0, 1.0)
        phase = (q(torch.atan2(patches.imag, patches.real).float()) + math.pi) / (2 * math.pi)
    else:
        amp = _minmax(log_amp)
        phase = torch.zeros_like(log_amp)
    planes = [(c - m) / s for c, m, s in zip((grad, amp, phase), IMAGENET_MEAN, IMAGENET_STD)]
    return q(torch.stack(planes, dim=-1))
