"""The coherent flagging path in plain PyTorch: the 8-channel images of a
4-pol block and the GroupNorm UNet that flags them.

The published model: U-Net (Ronneberger et al. 2015, arXiv:1505.04597)
with Group Normalization (Wu & He 2018, arXiv:1803.08494) in every
DoubleConv, as ``rfi_toolbox_tpu/models/unet.py`` builds it with
``norm="group"``: ``depth`` encoder stages of (bias-free 3x3 conv,
GroupNorm, ReLU) x 2 with ``f * 2**i`` features and a 2x2 max-pool, a
bottleneck DoubleConv of ``f * 2**depth``, decoder stages of a 2x2
stride-2 transposed conv with bias, ``[up, skip]`` concatenated and a
DoubleConv, and a 1x1 head with bias. GroupNorm (8 groups, eps 1e-6 at
the configuration's widths) normalises by each group's mean and biased
variance, then scales and shifts by channel. Parameters are named as the
program names them (``encoders.{i}.block.conv1.weight``,
``...norm1.weight``, ``decoders.{i}.up.weight``, ``head.weight``).

The images (the reference toolbox's coherent convention): each baseline's
four polarisations patchified together into 4 pols x (re, im) = 8
channels, pol0.re, pol0.im, pol1.re, ..., and each patch robust-scaled on
its own, ``(x - median) / max(q75 - q25, 1e-12)``, by the linear
quantiles (``q * (n - 1)`` into the sorted values, the neighbours joined
linearly), written out over a sort; a waterfall not a multiple of the
patch is zero-padded at its end, and the padding is left out of the
statistics.

Departures from the published description, each where the published
text leaves a choice open:

- the quantiles are the linear ones (numpy's default, ``jnp.percentile``'s
  and ``torch.quantile``'s), here by ``torch.sort`` and that
  interpolation written out, not by ``torch.nanquantile``;
- a waterfall whose sides are not multiples of the patch is zero-padded
  at its end (:func:`patchify`), and the padding is left out of each edge
  patch's statistics (the reference toolbox's ``jnp.nanmedian`` over
  padding set to NaN); the padded pixels are scaled like the rest and
  cropped by :func:`unpatchify`.

Everything runs in float32; the caller turns TF32 off (the loop's
comparison does, and turns it on for the control), and
:func:`coherent_images`' ``q`` rounds its intermediates (the control).
It imports nothing of the program and nothing of the tests; the tests'
plain reference (``tests/plain_coherent.py``) is this module.
"""

import json
import math

import numpy as np
import torch
import torch.nn.functional as F

QUARTILES = (0.25, 0.5, 0.75)


def _id(x):
    return x


def patchify(x, p):
    """(B, H, W) -> (B * ceil(H/p) * ceil(W/p), p, p), zero-padded at the
    end of each axis, patches row-major within each waterfall."""
    b, h, w = x.shape
    nh, nw = -(-h // p), -(-w // p)
    padded = x.new_zeros((b, nh * p, nw * p))
    padded[:, :h, :w] = x
    return padded.reshape(b, nh, p, nw, p).permute(0, 1, 3, 2, 4).reshape(-1, p, p)


def unpatchify(patches, b, h, w):
    """Inverse of :func:`patchify`, the padding cropped."""
    p = patches.shape[-1]
    nh, nw = -(-h // p), -(-w // p)
    x = patches.reshape(b, nh, nw, p, p).permute(0, 1, 3, 2, 4).reshape(b, nh * p, nw * p)
    return x[:, :h, :w]


def to_8ch(pols):
    """(..., 4, p, p) complex -> (..., p, p, 8) float32: pol0.re, pol0.im,
    pol1.re, pol1.im, ..."""
    planes = []
    for k in range(4):
        planes += [pols[..., k, :, :].real, pols[..., k, :, :].imag]
    return torch.stack(planes, dim=-1).float()


def quantiles(x, valid, qs=QUARTILES):
    """Linear quantiles of each row of (N, L) ``x`` over its ``valid``
    elements: sorted, ``q * (n - 1)`` in float32, the neighbours below and
    above joined as ``lo + frac * (hi - lo)``. Returns [q] of (N,)."""
    keyed = torch.where(valid, x, torch.full_like(x, math.inf))
    s = torch.sort(keyed, dim=1).values  # the valid values first
    n = valid.sum(dim=1)
    out = []
    for q in qs:
        pos = torch.tensor(q, dtype=torch.float32) * (n - 1).float()
        lo = pos.floor().long()
        hi = torch.minimum(lo + 1, n - 1)
        frac = pos - lo.float()
        a = s.gather(1, lo[:, None])[:, 0]
        b = s.gather(1, hi[:, None])[:, 0]
        out.append(a + frac * (b - a))
    return out


def robust_scale(x, valid):
    """(N, p, p, 8) float32 and (N, p, p) bool -> ``(x - median) /
    max(q75 - q25, 1e-12)`` a patch, its statistics over its valid
    pixels' 8 channels."""
    n = x.shape[0]
    keep = valid[..., None].expand(x.shape).reshape(n, -1)
    q25, med, q75 = quantiles(x.reshape(n, -1), keep)
    shape = (n, 1, 1, 1)
    return (x - med.view(shape)) / (q75 - q25).clamp_min(1e-12).view(shape)


def coherent_images(vis4, p, q=None):
    """(B, 4, C, T) complex64 -> (B * N, p, p, 8) float32 robust-scaled
    images, N patches a baseline in :func:`patchify`'s order."""
    q = q or _id
    b, _, c, t = vis4.shape
    patches = patchify(vis4.reshape(b * 4, c, t), p)
    n = patches.shape[0] // (b * 4)
    x = q(to_8ch(patches.reshape(b, 4, n, p, p).transpose(1, 2)))  # (b, n, p, p, 8)
    valid = patchify(torch.ones((1, c, t), device=vis4.device), p) > 0  # (n, p, p)
    valid = valid.expand(b, n, p, p).reshape(b * n, p, p)
    return q(robust_scale(x.reshape(b * n, p, p, 8), valid))


def load_snapshot(path):
    """A published GroupNorm ``.npz`` snapshot (Flax variables: HWIO
    kernels, the transposed conv's kernel applied mirrored; ``GroupNorm_k``
    scale and bias; no batch statistics) -> (params, metadata), named as
    the program names them."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__metadata__")).decode()) if "__metadata__" in flat else {}
    p = {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}
    depth = sum(k.startswith("Encoder_") and k.endswith("Conv_0/kernel") for k in p)
    params = {}

    def double(dst, src):
        for i in (1, 2):
            params[f"{dst}.conv{i}.weight"] = p[f"{src}/Conv_{i - 1}/kernel"].transpose(3, 2, 0, 1)
            params[f"{dst}.norm{i}.weight"] = p[f"{src}/GroupNorm_{i - 1}/scale"]
            params[f"{dst}.norm{i}.bias"] = p[f"{src}/GroupNorm_{i - 1}/bias"]

    for i in range(depth):
        double(f"encoders.{i}.block", f"Encoder_{i}/DoubleConv_0")
    double("bottleneck", "DoubleConv_0")
    for i in range(depth):
        up = p[f"Decoder_{i}/ConvTranspose_0/kernel"][::-1, ::-1]
        params[f"decoders.{i}.up.weight"] = up.transpose(2, 3, 0, 1)
        params[f"decoders.{i}.up.bias"] = p[f"Decoder_{i}/ConvTranspose_0/bias"]
        double(f"decoders.{i}.block", f"Decoder_{i}/DoubleConv_0")
    params["head.weight"] = p["Conv_0/kernel"].transpose(3, 2, 0, 1)
    params["head.bias"] = p["Conv_0/bias"]
    return ({k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in params.items()},
            meta)


def group_norm(h, weight, bias, groups, eps):
    """GroupNorm of (N, C, H, W) from each group's mean and biased
    variance, then the per-channel scale and shift."""
    n, c, hh, ww = h.shape
    g = h.reshape(n, groups, c // groups, hh, ww)
    mean = g.mean(dim=(2, 3, 4), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(2, 3, 4), keepdim=True)
    y = ((g - mean) / torch.sqrt(var + eps)).reshape(n, c, hh, ww)
    return y * weight.view(1, c, 1, 1) + bias.view(1, c, 1, 1)


def forward(params, x, depth=4, groups=8, eps=1e-6):
    """(N, C, H, W) float32 -> (N, H, W) logits."""

    def double(h, prefix):
        for i in (1, 2):
            h = F.conv2d(h, params[f"{prefix}.conv{i}.weight"], padding=1)
            h = torch.relu(group_norm(h, params[f"{prefix}.norm{i}.weight"],
                                      params[f"{prefix}.norm{i}.bias"], groups, eps))
        return h

    skips = []
    for i in range(depth):
        s = double(x, f"encoders.{i}.block")
        skips.append(s)
        x = F.max_pool2d(s, 2)
    x = double(x, "bottleneck")
    for i in range(depth):
        up = F.conv_transpose2d(x, params[f"decoders.{i}.up.weight"],
                                params[f"decoders.{i}.up.bias"], stride=2)
        x = double(torch.cat([up, skips[depth - 1 - i]], dim=1), f"decoders.{i}.block")
    return F.conv2d(x, params["head.weight"], params["head.bias"])[:, 0]


def logits(params, images, batch, depth=4, groups=8, eps=1e-6):
    """(N, p, p, 8) images -> (N, p, p) logits, the forward run in blocks
    of ``batch`` images (each image's logits depend on it alone)."""
    with torch.no_grad():
        return torch.cat([forward(params, images[i:i + batch].permute(0, 3, 1, 2).contiguous(),
                                  depth, groups, eps)
                          for i in range(0, images.shape[0], batch)])
