"""The folded UNet's inference forward in channels-last, 3x3 convs on K6a.

:class:`NHWCForward` is the forward that ``serving.CompiledPredictor``
runs for the models it covers (:meth:`NHWCForward.covers`): a float32
``norm="none"`` UNet with ReLU, no space-to-depth packing and no final
sigmoid, which is what ``models.fold_batchnorm`` makes of a BatchNorm
UNet. It takes the model's weights once, at construction, in the layouts
its products want, and keeps the activations NHWC from the images to the
logits:

- each DoubleConv is two K6a calls (``ops.conv3x3_call``) with the bias
  and the ReLU fused: HWIO ``(3, 3, Ci, Co)`` float32 weights;
- the 2x2 max-pool runs on the NHWC tensor;
- each 2x2 stride-2 up-conv is one float32 product ``(N*H*W, Ci) @
  (Ci, 4*Co)`` plus bias (TF32 stays as the caller set it: off on the
  predictor's card), scattered into the first ``Co`` channels of the
  ``[up, skip]`` concatenation, whose other half is the skip;
- the 1x1 head is one float32 matrix-vector product, giving the first
  logit channel as ``(B, H, W)``.

The JAX serving forward runs pooling, up-convs, concatenation and head as
XLA ops, without a Pallas kernel; the plain PyTorch ops here are their
counterpart. On the CPU ``conv3x3_call`` runs its plain version, so the
same code runs there. Later changes to the model's parameters are not
seen: the weights are copies. Importing this module sets nothing.

:class:`~.nhwc_groupnorm.GroupNormNHWCForward` (route ``"k7_nhwc"``) is
this skeleton with another block: it overrides ``norm``, ``_double`` and
``_double_conv`` alone, so pool, up-convs and head are these.
"""

import torch
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3_call
from ..utils.profiling import span
from .unet import UNet

__all__ = ["NHWCForward"]


def _copy(t):
    """A contiguous float32 copy of ``t``, which shares no storage with it."""
    return t.detach().to(torch.float32).clone(memory_format=torch.contiguous_format)


def _hwio(conv):
    return _copy(conv.weight.permute(2, 3, 1, 0))


def _bias(module):
    return _copy(module.bias)


def _up(conv):
    """(Ci, 4*Co) weights, columns in (dy, dx, co) order, and the bias
    repeated to match, of a 2x2 stride-2 transposed conv."""
    ci, co = conv.weight.shape[:2]
    return _copy(conv.weight.permute(0, 2, 3, 1).reshape(ci, 4 * co)), _bias(conv).repeat(4)


class NHWCForward:
    """The forward of a covered UNet on (B, H, W, C) images -> (B, H, W)
    float32 logits (the first output channel), in the ``predict.nhwc``
    span. Call it under ``torch.inference_mode()``.

    The skeleton (pool, up-convs, head) is shared with the GroupNorm
    forward (:class:`~.nhwc_groupnorm.GroupNormNHWCForward`), which takes
    another ``norm`` and its own block: ``_double`` takes a DoubleConv's
    weights, ``_double_conv`` runs it."""

    norm = "none"

    @classmethod
    def covers(cls, model):
        """Whether ``model`` is a UNet this forward computes: float32,
        ``norm`` as the class's, ReLU, no space-to-depth, no final sigmoid."""
        return (isinstance(model, UNet) and model.norm == cls.norm
                and model.dtype == torch.float32 and model.activation is torch.relu
                and not model.space_to_depth and not model.final_sigmoid)

    @torch.no_grad()
    def __init__(self, model):
        if not self.covers(model):
            raise ValueError(f"{type(self).__name__} takes a float32 norm={self.norm!r} ReLU "
                             "UNet without space-to-depth or a final sigmoid")
        self.encoders = [self._double(enc.block) for enc in model.encoders]
        self.bottleneck = self._double(model.bottleneck)
        self.decoders = [(_up(dec.up), self._double(dec.block)) for dec in model.decoders]
        self.head = _copy(model.head.weight[0, :, 0, 0]), _bias(model.head)[:1]

    def __call__(self, images):
        with span("predict.nhwc"):
            x = images.to(torch.float32).contiguous()
            skips = []
            for block in self.encoders:
                skip = self._double_conv(x, block)
                skips.append(skip)
                x = F.max_pool2d(skip.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1).contiguous()
            x = self._double_conv(x, self.bottleneck)
            for (up, block), skip in zip(self.decoders, reversed(skips)):
                x = self._double_conv(_up_and_concat(x, up, skip), block)
            w, b = self.head
            n, h, wd, c = x.shape
            return torch.addmv(b, x.view(-1, c), w).view(n, h, wd)

    @staticmethod
    def _double(block):
        return ((_hwio(block.conv1), _bias(block.conv1)),
                (_hwio(block.conv2), _bias(block.conv2)))

    @staticmethod
    def _double_conv(x, block):
        (w1, b1), (w2, b2) = block
        return conv3x3_call(conv3x3_call(x, w1, b1, relu=True), w2, b2, relu=True)


def _up_and_concat(x, up, skip):
    """``cat([conv_transpose2x2(x), skip], channels)`` in NHWC: the product's
    (dy, dx) columns written straight into their pixels of the first half."""
    w, b = up
    n, h, wd, ci = x.shape
    co = w.shape[1] // 4
    y = torch.addmm(b, x.view(-1, ci), w).view(n, h, wd, 2, 2, co)
    out = x.new_empty((n, 2 * h, 2 * wd, co + skip.shape[3]))
    out.view(n, h, 2, wd, 2, -1)[..., :co].copy_(y.permute(0, 1, 3, 2, 4, 5))
    out[..., co:].copy_(skip)
    return out
