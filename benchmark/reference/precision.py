"""Roundings that stand for a lower precision than the configuration
states: the control put in the program's place."""

import torch

FP8_MAX = 448.0  # float8 e4m3's largest finite value


def bf16(x):
    """``x`` rounded to bfloat16 and back (float32 results)."""
    return x.to(torch.bfloat16).to(x.dtype)


def fp8(x):
    """``x`` rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude mapped to e4m3's largest value, as fp8 training scales its
    operands), and back. The rounding passes the gradient straight
    through."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = FP8_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()

