"""Port parity: K7 (double_conv_gn_relu) through its plain version on the
CPU, against the JAX package's fused DoubleConv kernel in interpret mode
and against the port's own DoubleConv(norm="group") eval forward.

Tolerance 2e-4 absolute and relative, the JAX package's own
(tests/test_ops.py::test_double_conv_gn_relu_parity).

On the card K7's convolutions run in 3xTF32 on the tensor cores, with a
float32 accumulation that truncates at each MMA. The
test_3xtf32_doubleconv_* tests emulate that arithmetic (_conv_mma)
against float64: 64 channels within a tenth of chip_smoke.py's gate,
K7's deepest reduction (256 input channels) within a quarter of it, and
single TF32 past the gate and at least 10x farther.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import K7_RTOL
from rfi_toolbox_tpu.ops.fused_doubleconv import double_conv_gn_relu as jax_double_conv
from rfi_toolbox_tpu_torch.models.unet import DoubleConv
from rfi_toolbox_tpu_torch.ops import double_conv_gn_relu, double_conv_gn_relu_plain


def _weights(rng, ci, co):
    """HWIO kernels ~ N(0, 1/fan_in) and non-trivial GroupNorm affines."""
    w1 = (rng.normal(size=(3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32)
    w2 = (rng.normal(size=(3, 3, co, co)) / np.sqrt(9 * co)).astype(np.float32)
    g1, b1, g2, b2 = (rng.normal(1.0 if k % 2 == 0 else 0.0, 0.3, co).astype(np.float32)
                      for k in range(4))
    return w1, g1, b1, w2, g2, b2


@pytest.mark.parametrize("ci, co, groups", [(8, 16, 8), (16, 16, 8), (3, 12, 4)],
                         ids=["ci_ne_co", "ci_eq_co", "ci3"])
def test_matches_pallas(rng, ci, co, groups):
    x = rng.normal(size=(2, 16, 16, ci)).astype(np.float32)
    params = _weights(rng, ci, co)
    want = jax_double_conv(jnp.asarray(x), *map(jnp.asarray, params),
                           num_groups=groups, interpret=True)
    got = double_conv_gn_relu(torch.from_numpy(x), *map(torch.from_numpy, params),
                              num_groups=groups)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("ci, co", [(3, 16), (32, 16)])
def test_matches_port_double_conv(rng, ci, co):
    """The UNet's DoubleConv(norm='group') eval forward, whose weights the
    kernel takes in HWIO; groups gcd(co, 8)."""
    block = DoubleConv(ci, co, norm="group").eval()
    w1, g1, b1, w2, g2, b2 = _weights(rng, ci, co)
    with torch.no_grad():
        block.conv1.weight.copy_(torch.from_numpy(w1).permute(3, 2, 0, 1))
        block.conv2.weight.copy_(torch.from_numpy(w2).permute(3, 2, 0, 1))
        for norm, g, b in ((block.norm1, g1, b1), (block.norm2, g2, b2)):
            norm.weight.copy_(torch.from_numpy(g))
            norm.bias.copy_(torch.from_numpy(b))
        x = torch.from_numpy(rng.normal(size=(2, 16, 16, ci)).astype(np.float32))
        want = block(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = double_conv_gn_relu(x, *map(torch.from_numpy, (w1, g1, b1, w2, g2, b2)),
                                  num_groups=block.norm1.num_groups, eps=block.norm1.eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4, rtol=2e-4)


def test_cpu_tensors_take_the_plain_version(rng):
    x = torch.from_numpy(rng.normal(size=(1, 8, 8, 4)).astype(np.float32))
    before = double_conv_gn_relu.launches
    double_conv_gn_relu(x, *map(torch.from_numpy, _weights(rng, 4, 8)), num_groups=8)
    assert double_conv_gn_relu.launches == before


def _tf32(t):
    """float32 -> TF32 as cvt.rna rounds: to nearest on the low 13 mantissa
    bits, ties away from zero (finite inputs)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _chop(t):
    """float64 -> float32 rounded toward zero: how the tensor cores
    normalise a float32 accumulation (an mma.sync adds its exact products
    to the accumulator and truncates the sum)."""
    f = t.float()
    return torch.where(f.double().abs() > t.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _hi(t):
    return _tf32(t)


def _lo(t):
    return _tf32(t - _tf32(t))


# (x part, w part) of each MMA of a product, in K7's order
THREE = [(_lo, _hi), (_hi, _lo), (_hi, _hi)]
SINGLE = [(_hi, _hi)]


def _conv_mma(x, w, parts):
    """NHWC x, HWIO w: the SAME 3x3 conv as K7's m16n8k8 MMAs form it, K
    in steps of one tap x 8 input channels (channel chunks outer, taps
    inner), each step adding the product of each (x part, w part) to one
    float32 accumulator that truncates (_chop)."""
    n, h, wd, ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + h, kx:kx + wd] for ky in range(3) for kx in range(3)], 1)
    pairs = [(a(cols).double(), b(w).double().reshape(9, ci, -1)) for a, b in parts]
    acc = torch.zeros(n, h, wd, w.shape[3])
    for c in range(0, ci, 8):
        for t in range(9):
            for xa, wa in pairs:
                acc = _chop(acc.double() + xa[:, t, ..., c:c + 8] @ wa[t, c:c + 8])
    return acc


def _gn_relu(y, g, b, groups=8):
    return torch.relu(F.group_norm(y.permute(0, 3, 1, 2), groups, g, b, 1e-6)).permute(0, 2, 3, 1)


def _doubleconv_errors(rng, n, side, c):
    """(3xTF32, single TF32) emulated errors of a c -> c DoubleConv on n
    side x side images against float64, as shares of the output's max."""
    x = torch.from_numpy(rng.normal(size=(n, side, side, c)).astype(np.float32))
    w1, g1, b1, w2, g2, b2 = map(torch.from_numpy, _weights(rng, c, c))
    want = double_conv_gn_relu_plain(*(t.double() for t in (x, w1, g1, b1, w2, g2, b2)))

    def emulated(parts):
        y = _gn_relu(_conv_mma(x, w1, parts), g1, b1)
        return _gn_relu(_conv_mma(y, w2, parts), g2, b2)

    scale = float(want.abs().max())
    return [float((emulated(parts).double() - want).abs().max()) / scale
            for parts in (THREE, SINGLE)]


def test_3xtf32_doubleconv_error_budget(rng):
    """The DoubleConv at 64 -> 64 channels on 16 x 16 (K = 9 x 64 per
    output): 3xTF32 within a tenth of the gate, single TF32 past it."""
    err3, err1 = _doubleconv_errors(rng, 2, 16, 64)
    assert err3 <= K7_RTOL / 10, err3
    assert err1 > K7_RTOL, err1
    assert err1 >= 10 * err3, (err1, err3)


def test_3xtf32_doubleconv_deepest_reduction(rng):
    """K7's deepest reduction, 256 input channels (K = 9 x 256, the GroupNorm
    UNet16's 8 x 8 bottleneck and the decoder block after it): the
    truncation grows with K, so this is K7's worst case; within a quarter
    of the gate, single TF32 past it."""
    err3, err1 = _doubleconv_errors(rng, 2, 8, 256)
    assert err3 <= K7_RTOL / 4, err3
    assert err1 > K7_RTOL, err1
    assert err1 >= 10 * err3, (err1, err3)
