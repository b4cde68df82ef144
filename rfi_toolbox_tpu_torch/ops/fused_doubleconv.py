"""K7: the GroupNorm DoubleConv forward on the card.

Counterpart of ``rfi_toolbox_tpu/ops/fused_doubleconv.py:
double_conv_gn_relu``: ``relu(GN(conv3x3(relu(GN(conv3x3(x, W1))), W2)))``
with GroupNorm over contiguous channel groups (eps 1e-6 by default), the
eval forward of the UNet's ``DoubleConv(norm="group")``. NHWC float32
activations, HWIO weights; inputs of another dtype are cast to float32.
Forward only, as the JAX kernel: on the card it raises when a gradient
is wanted.

The kernel is ``csrc/double_conv_gn.cu`` on ``csrc/conv3x3_mma.cuh``'s
tensor-core tile in 3xTF32 (float32 accuracy): five launches per call,
which count as one (``double_conv_gn_relu.launches``). Its plain version,
:func:`double_conv_gn_relu_plain`, is the port's ``DoubleConv``
arithmetic (``F.conv2d`` and ``F.group_norm``); the wrapper runs it for
a CPU tensor. The TPU's ``double_conv_fits_vmem`` has no counterpart:
the kernel tiles the image and takes every shape.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _lib

__all__ = ["double_conv_gn_relu", "double_conv_gn_relu_plain"]


def double_conv_gn_relu_plain(x, w1, g1, b1, w2, g2, b2, num_groups=8, eps=1e-6):
    """Plain version of K7, in the input's float dtype."""
    y = x.permute(0, 3, 1, 2)
    for w, g, b in ((w1, g1, b1), (w2, g2, b2)):
        y = F.conv2d(y, w.permute(3, 2, 0, 1), padding=1)
        y = torch.relu(F.group_norm(y, num_groups, g, b, eps))
    return y.permute(0, 2, 3, 1)


def double_conv_gn_relu(x, w1, g1, b1, w2, g2, b2, num_groups=8, eps=1e-6):
    """The DoubleConv (norm='group') eval forward: NHWC ``x`` (N, H, W, Ci),
    ``w1`` (3, 3, Ci, Co), ``w2`` (3, 3, Co, Co), GroupNorm scales
    ``g1``, ``g2`` and biases ``b1``, ``b2`` (Co,) -> (N, H, W, Co) float32.

    A CPU tensor goes through the plain version. On the card,
    ``num_groups`` must divide Co and be at most ``kMaxGroups`` (64,
    ``csrc/conv3x3_mma.cuh``).
    """
    args = [t.to(torch.float32).contiguous() for t in (x, w1, g1, b1, w2, g2, b2)]
    x, w1, g1, b1, w2, g2, b2 = args
    if x.device.type == "cpu":
        return double_conv_gn_relu_plain(*args, num_groups=num_groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("double_conv_gn_relu is forward only: run it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.ndim != 4:
        raise ValueError(f"x: expected (N, H, W, Ci), got {tuple(x.shape)}")
    n, h, w, ci = x.shape
    co = w1.shape[3]
    if tuple(w1.shape) != (3, 3, ci, co) or tuple(w2.shape) != (3, 3, co, co):
        raise ValueError(f"weights: expected (3, 3, {ci}, Co) and (3, 3, Co, Co), "
                         f"got {tuple(w1.shape)} and {tuple(w2.shape)}")
    if any(tuple(t.shape) != (co,) for t in (g1, b1, g2, b2)):
        raise ValueError(f"GroupNorm scales and biases must be ({co},)")
    if any(t.device != x.device for t in args):
        raise ValueError("all tensors must be on one device")
    if x.numel() == 0 or co == 0:
        raise ValueError(f"empty input {tuple(x.shape)} or no output channels")
    lib = _lib.load()
    slots = ctypes.c_longlong()  # the kernel's (sum, sum of squares) partials
    if lib.rfi_double_conv_gn_workspace(n, h, w, co, int(num_groups), ctypes.byref(slots)):
        raise ValueError(f"num_groups {num_groups} must divide {co} and be at most "
                         "kMaxGroups (csrc/conv3x3_mma.cuh)")
    out = torch.empty((n, h, w, co), dtype=torch.float32, device=x.device)
    mid = torch.empty_like(out)
    stats1 = torch.empty(2 * slots.value, dtype=torch.float64, device=x.device)
    stats2 = torch.empty_like(stats1)
    rc = lib.rfi_double_conv_gn(
        *(t.data_ptr() for t in (x, w1, g1, b1, w2, g2, b2, mid, out, stats1, stats2)),
        n, h, w, ci, co, int(num_groups), float(eps), _lib.stream_of(x))
    _lib.check(rc, "double_conv_gn_relu")
    double_conv_gn_relu.launches += 1
    return out


double_conv_gn_relu.launches = 0
