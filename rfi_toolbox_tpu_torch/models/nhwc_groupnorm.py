"""The GroupNorm UNet's inference forward in channels-last, DoubleConvs on K7.

:class:`GroupNormNHWCForward` is the forward that
``serving.CompiledPredictor`` runs (route ``"k7_nhwc"``) for the models it
covers: a float32 ``norm="group"`` UNet with ReLU, no space-to-depth
packing and no final sigmoid, such as the snapshots
``unet16gn_coherent8ch``, ``unet24gn_coherent8ch``,
``unet32gn_coherent8ch`` and ``unet16gn_universal``. It takes the model's
weights once, at construction, and keeps the activations NHWC from the
images to the logits:

- each DoubleConv is one K7 call (``ops.double_conv_gn_relu``): conv,
  GroupNorm and ReLU twice, on HWIO ``(3, 3, Ci, Co)`` float32 weights
  (the convs carry no bias under GroupNorm), the two GroupNorms' scales
  and biases, and the module's ``num_groups`` and eps (both norms of a
  DoubleConv are built alike, ``models/unet.py:_norm``);
- the 2x2 max-pool, the 2x2 stride-2 up-convs scattered into the
  ``[up, skip]`` concatenation and the 1x1 head are
  :class:`~.nhwc_forward.NHWCForward`'s own: float32 products, TF32 as
  the caller set it (off on the predictor's card).

It subclasses :class:`~.nhwc_forward.NHWCForward` (the ``"k6a_nhwc"``
route of folded BatchNorm UNets) and overrides the block alone: K6a with
a bias and the ReLU there, K7 with the GroupNorms here. GroupNorm's
statistics span each image, so they cannot be folded into the convs as
BatchNorm's running statistics are, and the choice falls on the model's
``norm``.

On the CPU ``double_conv_gn_relu`` runs its plain version (``F.conv2d``
and ``F.group_norm``), so the same code runs there. Later changes to the
model's parameters are not seen: the weights are copies. Importing this
module sets nothing.
"""

from ..ops.fused_doubleconv import double_conv_gn_relu
from .nhwc_forward import NHWCForward, _copy, _hwio

__all__ = ["GroupNormNHWCForward"]


class GroupNormNHWCForward(NHWCForward):
    """:class:`~.nhwc_forward.NHWCForward` for ``norm="group"``, each
    DoubleConv one K7 call."""

    norm = "group"

    @staticmethod
    def _double(block):
        """A DoubleConv's K7 arguments, and its groups and eps."""
        n1, n2 = block.norm1, block.norm2
        args = (_hwio(block.conv1), _copy(n1.weight), _copy(n1.bias),
                _hwio(block.conv2), _copy(n2.weight), _copy(n2.bias))
        return args, {"num_groups": n1.num_groups, "eps": n1.eps}

    @staticmethod
    def _double_conv(x, block):
        args, kw = block
        return double_conv_gn_relu(x, *args, **kw)
