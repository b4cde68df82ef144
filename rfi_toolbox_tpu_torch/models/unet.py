"""UNet for RFI segmentation in PyTorch.

Counterpart of ``rfi_toolbox_tpu/models/unet.py`` (``DoubleConv``,
``Encoder``, ``ConvTranspose2x2``, ``Decoder``, ``_UNetBase``/``UNet``,
the variants ``UNetBigger``, ``UNetOverfit`` and
``UNetDifferentActivation``, ``create_model``,
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
  1x1 head;
- ``dtype`` is the compute type (bfloat16 on the training path):
  parameters stay float32 and are cast for each conv, norm statistics
  are reduced in float32, and the logits come back as float32;
- BatchNorm in training mode normalises by the batch statistics and
  updates the running ones as Flax does: ``r = 0.9 r + 0.1 s`` (Flax
  momentum 0.9, torch momentum 0.1) with the *biased* batch variance,
  where ``nn.BatchNorm2d`` would store the unbiased one;
- Flax's initialisers (:func:`flax_init_`: truncated-normal
  ``lecun_normal`` kernels, zero biases, norm scale 1 and bias 0) are
  applied where the JAX package initialises, by
  ``train.create_train_state`` with a seed; the constructor leaves
  PyTorch's defaults.

Weights converted from a Flax snapshot load with
:func:`rfi_toolbox_tpu_torch.models.convert.params_from_flax`.
"""

import math

import torch
from torch import nn

from ..parallel.functional import all_reduce_sum, group_size

__all__ = [
    "BatchNorm",
    "Conv2d",
    "DoubleConv",
    "Encoder",
    "ConvTranspose2x2",
    "Decoder",
    "UNet",
    "UNetBigger",
    "UNetOverfit",
    "UNetDifferentActivation",
    "create_model",
    "space_to_depth",
    "depth_to_space",
    "flax_init_",
]

BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm default
GROUP_NORM_EPS = 1e-6  # flax nn.GroupNorm default
FLAX_MOMENTUM = 0.9  # the JAX UNet's nn.BatchNorm(momentum=0.9)


def _at_least_f32(dtype):
    return torch.promote_types(dtype, torch.float32)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose float32 parameters are cast to the input's
    dtype for the convolution, as Flax's ``nn.Conv(dtype=...)`` does."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm with Flax's semantics (eps 1e-5).

    Eval mode normalises by the running statistics. Training mode
    normalises by the batch statistics (reduced in float32, also for a
    bfloat16 input, whose output stays bfloat16) and then sets
    ``running = 0.9 * running + 0.1 * batch`` with the biased batch
    variance, as Flax stores it.

    ``group``, a process group set by the trainer for its steps (None
    otherwise), makes training mode take the statistics of the rows of
    all the group's ranks, as Flax does over a batch sharded on a mesh:
    each rank's sum, then its sum of squared deviations from the global
    mean, all-reduced (a summing backward, since every rank's gradient
    holds only its rows' share), with the same biased variance, eps and
    momentum. ``nn.SyncBatchNorm`` would store the unbiased variance.
    """

    def __init__(self, features):
        super().__init__(features, eps=BATCH_NORM_EPS)
        self.group = None

    def forward(self, x):
        if not self.training:
            return nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps)
        if self.group is not None:
            return self._forward_global(x)
        # momentum 1 leaves exactly the batch mean and the unbiased batch
        # variance in the two scratch vectors
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = nn.functional.batch_norm(x, mean, var, self.weight, self.bias,
                                     True, 1.0, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            biased = var * ((n - 1) / n)
            self.running_mean.mul_(FLAX_MOMENTUM).add_(mean, alpha=1 - FLAX_MOMENTUM)
            self.running_var.mul_(FLAX_MOMENTUM).add_(biased, alpha=1 - FLAX_MOMENTUM)
            self.num_batches_tracked.add_(1)
        return y

    def _forward_global(self, x):
        xf = x.to(_at_least_f32(x.dtype))
        dims, shape = (0, 2, 3), (1, -1, 1, 1)
        n = xf.numel() // xf.shape[1] * group_size(self.group)
        mean = all_reduce_sum(xf.sum(dims), self.group) / n
        centred = xf - mean.view(shape)
        var = all_reduce_sum(centred.square().sum(dims), self.group) / n
        y = centred * torch.rsqrt(var + self.eps).view(shape) * self.weight.view(shape)
        y = y + self.bias.view(shape)
        with torch.no_grad():
            self.running_mean.mul_(FLAX_MOMENTUM).add_(mean, alpha=1 - FLAX_MOMENTUM)
            self.running_var.mul_(FLAX_MOMENTUM).add_(var, alpha=1 - FLAX_MOMENTUM)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm (Flax's eps 1e-6) with statistics in float32 (float64 for
    a float64 input); the output keeps the input's dtype."""

    def forward(self, x):
        y = nn.functional.group_norm(x.to(_at_least_f32(x.dtype)), self.num_groups,
                                     self.weight, self.bias, self.eps)
        return y.to(x.dtype)


def _norm(kind, features):
    if kind == "batch":
        return BatchNorm(features)
    if kind == "group":
        return GroupNorm(math.gcd(features, 8), features, eps=GROUP_NORM_EPS)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm: {kind!r}")


class DoubleConv(nn.Module):
    """(Conv3x3 -> norm -> activation) x 2; the activation is ReLU unless
    another callable is given."""

    def __init__(self, in_channels, features, norm="batch", activation=torch.relu):
        super().__init__()
        bias = norm == "none"
        self.activation = activation
        self.conv1 = Conv2d(in_channels, features, 3, padding=1, bias=bias)
        self.norm1 = _norm(norm, features)
        self.conv2 = Conv2d(features, features, 3, padding=1, bias=bias)
        self.norm2 = _norm(norm, features)

    def forward(self, x):
        x = self.activation(self.norm1(self.conv1(x)))
        return self.activation(self.norm2(self.conv2(x)))


class Encoder(nn.Module):
    """DoubleConv then 2x2 max-pool; returns (pooled, skip)."""

    def __init__(self, in_channels, features, norm="batch", activation=torch.relu):
        super().__init__()
        self.block = DoubleConv(in_channels, features, norm, activation)

    def forward(self, x):
        skip = self.block(x)
        return nn.functional.max_pool2d(skip, 2), skip


class ConvTranspose2x2(nn.ConvTranspose2d):
    """2x2 / stride-2 transposed conv. The Flax module applies its kernel
    spatially mirrored; :func:`params_from_flax` mirrors it on the way in,
    so this is a plain ``nn.ConvTranspose2d``."""

    def __init__(self, in_channels, features):
        super().__init__(in_channels, features, 2, stride=2)

    def forward(self, x):
        return nn.functional.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=2)


class Decoder(nn.Module):
    """Upsample, concatenate ``[up, skip]``, DoubleConv."""

    def __init__(self, in_channels, features, norm="batch", activation=torch.relu):
        super().__init__()
        self.up = ConvTranspose2x2(in_channels, features)
        self.block = DoubleConv(2 * features, features, norm, activation)

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
        dtype: compute dtype (float32 or bfloat16); parameters stay
            float32.
        activation: the DoubleConvs' activation, a callable on tensors
            (``torch.relu``; e.g. ``nn.functional.leaky_relu``).
        final_sigmoid: apply a sigmoid to the output (``UNetOverfit``).
    """

    def __init__(self, in_channels=3, out_channels=1, init_features=32,
                 depth=4, norm="batch", space_to_depth=False,
                 dtype=torch.float32, activation=torch.relu,
                 final_sigmoid=False):
        super().__init__()
        self.dtype = dtype
        f = init_features
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.init_features = init_features
        self.depth = depth
        self.norm = norm
        self.space_to_depth = space_to_depth
        self.activation = activation
        self.final_sigmoid = final_sigmoid
        if space_to_depth:
            stage_features = [f * 2 ** (i + 1) for i in range(depth - 1)]
            c = 4 * in_channels
        else:
            stage_features = [f * 2**i for i in range(depth)]
            c = in_channels
        self.encoders = nn.ModuleList()
        for feats in stage_features:
            self.encoders.append(Encoder(c, feats, norm, activation))
            c = feats
        self.bottleneck = DoubleConv(c, f * 2**depth, norm, activation)
        c = f * 2**depth
        self.decoders = nn.ModuleList()
        for feats in reversed(stage_features):
            self.decoders.append(Decoder(c, feats, norm, activation))
            c = feats
        head = 4 * out_channels if space_to_depth else out_channels
        self.head = Conv2d(c, head, 1)

    def config(self):
        """Constructor arguments, to rebuild the same architecture."""
        return {
            "in_channels": self.in_channels,
            "out_channels": self.out_channels,
            "init_features": self.init_features,
            "depth": self.depth,
            "norm": self.norm,
            "space_to_depth": self.space_to_depth,
            "dtype": self.dtype,
            "activation": self.activation,
            "final_sigmoid": self.final_sigmoid,
        }

    def forward(self, x):
        """(N, C, H, W) float -> (N, out_channels, H, W) float32 logits
        (probabilities with ``final_sigmoid``), computed in :attr:`dtype`."""
        x = x.to(self.dtype)
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
        x = depth_to_space(x) if self.space_to_depth else x
        x = x.to(torch.float32)
        return torch.sigmoid(x) if self.final_sigmoid else x


class UNetBigger(UNet):
    """5-stage UNet (``rfi_toolbox_tpu.models.UNetBigger``)."""

    def __init__(self, in_channels=3, out_channels=1, init_features=32, depth=5,
                 **kwargs):
        super().__init__(in_channels, out_channels, init_features, depth, **kwargs)


class UNetOverfit(UNet):
    """5-stage, 128-feature UNet with a sigmoid output
    (``rfi_toolbox_tpu.models.UNetOverfit``)."""

    def __init__(self, in_channels=3, out_channels=1, init_features=128, depth=5,
                 final_sigmoid=True, **kwargs):
        super().__init__(in_channels, out_channels, init_features, depth,
                         final_sigmoid=final_sigmoid, **kwargs)


class UNetDifferentActivation(UNet):
    """4-stage UNet whose activation is the caller's
    (``rfi_toolbox_tpu.models.UNetDifferentActivation``).

    >>> model = UNetDifferentActivation(activation=nn.functional.leaky_relu)
    """


_MODEL_REGISTRY = {
    "unet": UNet,
    "unet_bigger": UNetBigger,
    "unet_overfit": UNetOverfit,
    "unet_activation": UNetDifferentActivation,
}


def create_model(model_type="unet", out_channels=1, init_features=32,
                 dtype=torch.float32, **kwargs):
    """The UNet named ``model_type`` (the CLI's model names), as
    ``rfi_toolbox_tpu.models.create_model`` builds it."""
    if model_type not in _MODEL_REGISTRY:
        raise ValueError(
            f"Unknown model type: {model_type}. "
            f"Choose from {sorted(_MODEL_REGISTRY)}"
        )
    cls = _MODEL_REGISTRY[model_type]
    return cls(out_channels=out_channels, init_features=init_features,
               dtype=dtype, **kwargs)


@torch.no_grad()
def flax_init_(model, generator=None):
    """Give ``model``'s parameters Flax's initial values, in place:
    ``lecun_normal`` kernels (a normal of std ``sqrt(1 / fan_in) /
    0.8796``, truncated at two standard deviations; fan_in is the
    kernel's input channels times its spatial size), zero biases (or the
    constant a conv names in its ``bias_init`` attribute, as SOLOLite's
    category head does), norm scale 1 and bias 0, running mean 0 and
    variance 1. Returns ``model``."""
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
            w = module.weight
            if isinstance(module, nn.ConvTranspose2d):  # (Cin, Cout, kh, kw)
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:  # (Cout, Cin, kh, kw)
                fan_in = w[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if module.bias is not None:
                module.bias.fill_(getattr(module, "bias_init", 0.0))
        elif isinstance(module, (nn.BatchNorm2d, nn.GroupNorm)):
            module.reset_parameters()
    return model
