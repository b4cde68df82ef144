"""UNet for RFI segmentation in PyTorch.

Counterpart of ``rfi_toolbox_tpu/models/unet.py`` (``DoubleConv``,
``Encoder``, ``ConvTranspose2x2``, ``Decoder``, ``_UNetBase``/``UNet``,
``space_to_depth``/``depth_to_space``). The modules take and return
NCHW tensors, PyTorch's layout; the public NHWC layout of images is kept
by the callers (:mod:`rfi_toolbox_tpu_torch.serving`).

Semantics carried over from the Flax modules:

- ``norm``: ``"batch"`` (eps 1e-5, running statistics in eval mode),
  ``"group"`` (``gcd(features, 8)`` groups, Flax's eps 1e-6) or
  ``"none"`` (the 3x3 convs then carry a bias);
- the encoder's DoubleConv runs once and is reused as the skip;
- the decoder concatenates ``[up, skip]`` in that order;
- ``space_to_depth=True`` packs 2x2 pixels into channels, runs the
  network at half resolution and unpacks the logits with a 4x-channel
  1x1 head.

Weights converted from a Flax snapshot load with
:func:`rfi_toolbox_tpu_torch.models.convert.params_from_flax`.
"""

import math

import torch
from torch import nn

__all__ = [
    "DoubleConv",
    "Encoder",
    "ConvTranspose2x2",
    "Decoder",
    "UNet",
    "space_to_depth",
    "depth_to_space",
]

BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm default
GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm default


def _norm(kind, features):
    if kind == "batch":
        return nn.BatchNorm2d(features, eps=BATCH_NORM_EPS)
    if kind == "group":
        return nn.GroupNorm(math.gcd(features, 8), features, eps=GROUP_NORM_EPS)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm: {kind!r}")


class DoubleConv(nn.Module):
    """(Conv3x3 -> norm -> ReLU) x 2."""

    def __init__(self, in_channels, features, norm="batch"):
        super().__init__()
        bias = norm == "none"
        self.conv1 = nn.Conv2d(in_channels, features, 3, padding=1, bias=bias)
        self.norm1 = _norm(norm, features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=bias)
        self.norm2 = _norm(norm, features)

    def forward(self, x):
        x = torch.relu(self.norm1(self.conv1(x)))
        return torch.relu(self.norm2(self.conv2(x)))


class Encoder(nn.Module):
    """DoubleConv then 2x2 max-pool; returns (pooled, skip)."""

    def __init__(self, in_channels, features, norm="batch"):
        super().__init__()
        self.block = DoubleConv(in_channels, features, norm)

    def forward(self, x):
        skip = self.block(x)
        return nn.functional.max_pool2d(skip, 2), skip


class ConvTranspose2x2(nn.ConvTranspose2d):
    """2x2 / stride-2 transposed conv. The Flax module applies its kernel
    spatially mirrored; :func:`params_from_flax` mirrors it on the way in,
    so this is a plain ``nn.ConvTranspose2d``."""

    def __init__(self, in_channels, features):
        super().__init__(in_channels, features, 2, stride=2)


class Decoder(nn.Module):
    """Upsample, concatenate ``[up, skip]``, DoubleConv."""

    def __init__(self, in_channels, features, norm="batch"):
        super().__init__()
        self.up = ConvTranspose2x2(in_channels, features)
        self.block = DoubleConv(2 * features, features, norm)

    def forward(self, x, skip):
        return self.block(torch.cat([self.up(x), skip], dim=1))


def space_to_depth(x):
    """(B, C, H, W) -> (B, 4C, H/2, W/2); channel ``(2*dh + dw)*C + c``,
    the order of the Flax NHWC version."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def depth_to_space(x):
    """Inverse of :func:`space_to_depth`."""
    b, c, h, w = x.shape
    x = x.reshape(b, 2, 2, c // 4, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // 4, 2 * h, 2 * w)


class UNet(nn.Module):
    """Encoder-decoder UNet with ``depth`` stages, logits output.

    Args:
        in_channels: input image channels (3 for the flagging images).
        out_channels: logit channels.
        init_features: width of the first stage; stage i has
            ``init_features * 2**i`` and the bottleneck
            ``init_features * 2**depth``.
        depth: number of encoder/decoder stages (4 for ``UNet``).
        norm: ``"batch"``, ``"group"`` or ``"none"``.
        space_to_depth: the 2x2-packed variant (see module docstring).
    """

    def __init__(self, in_channels=3, out_channels=1, init_features=32,
                 depth=4, norm="batch", space_to_depth=False):
        super().__init__()
        f = init_features
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.init_features = init_features
        self.depth = depth
        self.norm = norm
        self.space_to_depth = space_to_depth
        if space_to_depth:
            stage_features = [f * 2 ** (i + 1) for i in range(depth - 1)]
            c = 4 * in_channels
        else:
            stage_features = [f * 2**i for i in range(depth)]
            c = in_channels
        self.encoders = nn.ModuleList()
        for feats in stage_features:
            self.encoders.append(Encoder(c, feats, norm))
            c = feats
        self.bottleneck = DoubleConv(c, f * 2**depth, norm)
        c = f * 2**depth
        self.decoders = nn.ModuleList()
        for feats in reversed(stage_features):
            self.decoders.append(Decoder(c, feats, norm))
            c = feats
        head = 4 * out_channels if space_to_depth else out_channels
        self.head = nn.Conv2d(c, head, 1)

    def config(self):
        """Constructor arguments, to rebuild the same architecture."""
        return {
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "init_features": self.init_features,
            "depth": self.depth,
            "norm": self.norm,
            "space_to_depth": self.space_to_depth,
        }

    def forward(self, x):
        """(N, C, H, W) float32 -> (N, out_channels, H, W) logits."""
        if self.space_to_depth:
            x = space_to_depth(x)
        skips = []
        for enc in self.encoders:
            x, skip = enc(x)
            skips.append(skip)
        x = self.bottleneck(x)
        for dec, skip in zip(self.decoders, reversed(skips)):
            x = dec(x, skip)
        x = self.head(x)
        return depth_to_space(x) if self.space_to_depth else x
