"""K6a and K6b: the direct 3x3 convolution and its weight gradient.

Counterpart of ``rfi_toolbox_tpu/ops/conv3x3.py``. The JAX layout is
kept: NHWC float32 activations, HWIO weights ``(3, 3, Ci, Co)``, SAME
padding; inputs of another dtype are cast to float32, as ``_conv_call``
casts.

- :func:`conv3x3_call` is K6a's wrapper (``csrc/conv3x3.cu`` on
  ``csrc/conv3x3_mma.cuh``): ``[relu](conv3x3(x, W) + b)``, the
  counterpart of ``_conv_call``, an implicit GEMM on the tensor cores in
  3xTF32 that sums each 8-channel chunk apart and adds the chunks in
  round-to-nearest (float32 accuracy at up to 512 input channels).
- :func:`conv3x3_dw` is K6b's wrapper: the weight gradient, the
  counterpart of ``_dw_call``, an implicit GEMM on the tensor cores in
  3xTF32 (each float32 operand split into two TF32 parts, three products:
  float32 accuracy; no TF32 switch is involved). Deterministic: the same
  inputs give the same bits.
- :func:`conv3x3_bias_relu` and :func:`conv3x3` are differentiable
  (``torch.autograd.Function``): dx is K6a on the 180-degree-rotated,
  channel-transposed weights without ReLU, dW is K6b and db a plain sum,
  as the JAX custom VJP computes them; ``conv3x3_bias_relu`` gates the
  output gradient by ``y > 0`` first. Unlike the JAX ``conv3x3``, which
  calls ``_conv_call`` outside the custom VJP, the port's ``conv3x3`` is
  differentiable as its docstring says.

A wrapper runs its plain PyTorch version (``*_plain``) for a CPU tensor
and launches its kernel for a CUDA tensor, or raises; nothing falls
back. ``conv3x3_call.launches`` and ``conv3x3_dw.launches`` count the
kernels' launches. The TPU's VMEM-budget helpers (``conv3x3_fits_vmem``,
``conv3x3_bias_relu_or_xla``) have no counterpart: the kernels tile the
image and take every shape.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _lib

__all__ = [
    "conv3x3_bias_relu",
    "conv3x3",
    "conv3x3_call",
    "conv3x3_call_plain",
    "conv3x3_dw",
    "conv3x3_dw_plain",
    "rotate_weight",
]


def conv3x3_call_plain(x, w, b=None, relu=False):
    """Plain version of K6a: ``F.conv2d`` on the NCHW view of NHWC ``x``
    with the OIHW view of HWIO ``w``, plus ``b``, then the ReLU if asked.
    Keeps the input's float dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1)
    y = y.permute(0, 2, 3, 1)
    return torch.relu(y) if relu else y


def conv3x3_dw_plain(x, g):
    """Plain version of K6b: for each tap, the zero-padded input shifted by
    the tap contracted with ``g`` over (n, h, w). x (N, H, W, Ci), g
    (N, H, W, Co) -> (3, 3, Ci, Co)."""
    _, h, w, ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [torch.einsum("nhwi,nhwo->io", xp[:, ky:ky + h, kx:kx + w], g)
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, ci, g.shape[-1])


def rotate_weight(w):
    """The weights of dx's convolution: ``w`` rotated by 180 degrees and
    its channels transposed, (3, 3, Ci, Co) -> (3, 3, Co, Ci)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _check_cuda(t, name, ndim):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def conv3x3_call(x, w, b=None, relu=False):
    """K6a: ``[relu](conv3x3_SAME(x, w) + b)`` for NHWC ``x`` (N, H, W, Ci)
    and ``w`` (3, 3, Ci, Co) -> (N, H, W, Co).

    A CPU tensor goes through the plain version. On the card every tensor
    must be contiguous float32 on the same device.
    """
    if x.device.type == "cpu":
        return conv3x3_call_plain(x, w, b, relu)
    _check_cuda(x, "x", 4)
    _check_cuda(w, "w", 4)
    n, h, wd, ci = x.shape
    co = w.shape[3]
    if tuple(w.shape[:3]) != (3, 3, ci):
        raise ValueError(f"w: expected (3, 3, {ci}, Co), got {tuple(w.shape)}")
    if b is not None:
        _check_cuda(b, "b", 1)
        if b.shape[0] != co:
            raise ValueError(f"b: expected ({co},), got {tuple(b.shape)}")
    y = torch.empty((n, h, wd, co), dtype=torch.float32, device=x.device)
    if ci == 0:
        raise ValueError("x has no input channels")
    if y.numel() == 0:
        return y
    rc =_lib.load().rfi_conv3x3(
        x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
        y.data_ptr(), n, h, wd, ci, co, int(bool(relu)), _lib.stream_of(x))
    _lib.check(rc, "conv3x3")
    conv3x3_call.launches += 1
    return y


conv3x3_call.launches = 0


def conv3x3_dw(x, g):
    """K6b: the weight gradient of a 3x3 SAME conv, x (N, H, W, Ci) and the
    output gradient g (N, H, W, Co) -> dW (3, 3, Ci, Co).

    A CPU tensor goes through the plain version. On the card both must be
    contiguous float32.
    """
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, g)
    _check_cuda(x, "x", 4)
    _check_cuda(g, "g", 4)
    n, h, wd, ci = x.shape
    co = g.shape[3]
    if tuple(g.shape[:3]) != (n, h, wd):
        raise ValueError(f"g: expected ({n}, {h}, {wd}, Co), got {tuple(g.shape)}")
    dw = torch.empty((3, 3, ci, co), dtype=torch.float32, device=x.device)
    if dw.numel() == 0 or n * h * wd == 0:
        return dw.zero_()
    lib = _lib.load()
    splits = ctypes.c_int()  # the kernel's split of the pixel reduction
    _lib.check(lib.rfi_conv3x3_dw_splits(n, h, wd, ci, co, ctypes.byref(splits)),
               "conv3x3_dw")
    splits = splits.value
    partial = dw if splits == 1 else torch.empty(
        (splits, 3, 3, ci, co), dtype=torch.float32, device=x.device)
    rc = lib.rfi_conv3x3_dw(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        n, h, wd, ci, co, splits, _lib.stream_of(x))
    _lib.check(rc, "conv3x3_dw")
    conv3x3_dw.launches += 1
    return dw


conv3x3_dw.launches = 0


def _grads(ctx, x, w, g):
    dx = dw = db = None
    if ctx.needs_input_grad[0]:
        dx = conv3x3_call(g, rotate_weight(w))
    if ctx.needs_input_grad[1]:
        dw = conv3x3_dw(x, g)
    if ctx.needs_input_grad[2]:
        db = g.sum((0, 1, 2))
    return dx, dw, db


class Conv3x3BiasReLU(torch.autograd.Function):
    """relu(conv3x3(x, w) + b) through K6a, differentiable through K6a
    (dx) and K6b (dW). Takes the dtype it is given (float32 on the card);
    the public :func:`conv3x3_bias_relu` casts."""

    @staticmethod
    def forward(ctx, x, w, b):
        y = conv3x3_call(x, w, b, relu=True)
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        return _grads(ctx, x, w, (g * (y > 0)).contiguous())


class Conv3x3(torch.autograd.Function):
    """conv3x3(x, w) [+ b] through K6a, differentiable through K6a (dx)
    and K6b (dW); ``b`` may be None."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        return conv3x3_call(x, w, b)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _grads(ctx, x, w, g.contiguous())


def _f32(t):
    return t.to(torch.float32).contiguous()


def conv3x3_bias_relu(x, w, b):
    """``relu(conv3x3_SAME(x, w) + b)`` for NHWC ``x`` and (3, 3, Ci, Co)
    ``w``, in float32; differentiable (dx by K6a, dW by K6b, db a sum)."""
    return Conv3x3BiasReLU.apply(_f32(x), _f32(w), _f32(b))


def conv3x3(x, w, b=None):
    """``conv3x3_SAME(x, w) [+ b]`` (no activation) in float32;
    differentiable as :func:`conv3x3_bias_relu`, without the ReLU gate."""
    return Conv3x3.apply(_f32(x), _f32(w), None if b is None else _f32(b))
