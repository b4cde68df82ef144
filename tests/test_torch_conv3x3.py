"""Port parity: K6a (conv3x3_call) and K6b (conv3x3_dw) through their
plain versions on the CPU, and the differentiable conv3x3_bias_relu and
conv3x3, against the JAX package's Pallas kernels in interpret mode.

Tolerances are the JAX package's own (tests/test_ops.py): 1e-4 on the
forward, 1e-3 on the gradients; the dW contraction 1e-4. gradcheck runs
the plain path in float64 at its default tolerances.

On the card K6b computes in 3xTF32 on the tensor cores (each float32
operand split into a TF32 hi and a TF32 lo, three products a product),
accumulating in float32 that truncates at each MMA. The test_3xtf32_dw_*
tests emulate that arithmetic here (_dw_mma) against float64: a short
chain within a tenth of chip_smoke.py's gate, K6b's longest chain within
a quarter of it, and single TF32 past the gate and at least 10x farther,
which is why single TF32 was refused.

K6a computes in 3xTF32 too, and sums each 8-channel chunk of its
reduction apart, adding the chunks to the running sum in round-to-nearest;
the test_3xtf32_k6a_* tests emulate that (_conv_mma) at 256 and 512 input
channels against float64 and against one running accumulator.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import CONV_RTOL, DW_RTOL
from rfi_toolbox_tpu.ops import conv3x3 as jax_conv3x3
from rfi_toolbox_tpu.ops import conv3x3_bias_relu as jax_conv3x3_bias_relu
from rfi_toolbox_tpu.ops.conv3x3 import _dw_call
from rfi_toolbox_tpu_torch.ops import (
    conv3x3,
    conv3x3_bias_relu,
    conv3x3_call,
    conv3x3_dw,
    conv3x3_dw_plain,
)
from rfi_toolbox_tpu_torch.ops.conv3x3 import Conv3x3, Conv3x3BiasReLU, rotate_weight


def _xla_conv(x, w, b=None, relu=True):
    y = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    if b is not None:
        y = y + b
    return jnp.maximum(y, 0.0) if relu else y


def _inputs(rng, n, hw, ci, co):
    x = rng.standard_normal((n, hw, hw, ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, ci, co)) * 0.1).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("ci, co, bias, relu", [
    (8, 16, True, True),    # conv3x3_bias_relu, as tests/test_ops.py
    (3, 16, True, True),    # the UNet's first layer: 3 input channels
    (8, 16, False, False),  # conv3x3 without bias
    (6, 5, True, False),    # conv3x3 with bias, ragged channels
], ids=["bias_relu", "ci3", "no_bias", "bias_ragged"])
def test_forward_matches_pallas(rng, ci, co, bias, relu):
    x, w, b = _inputs(rng, 2, 16, ci, co)
    if relu:
        want = jax_conv3x3_bias_relu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True)
        got = conv3x3_bias_relu(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    else:
        jb = jnp.asarray(b) if bias else None
        want = jax_conv3x3(jnp.asarray(x), jnp.asarray(w), jb, interpret=True)
        got = conv3x3(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b) if bias else None)
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, co)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)


def test_inputs_are_cast_to_float32(rng):
    x, w, b = _inputs(rng, 1, 8, 4, 4)
    got = conv3x3_bias_relu(torch.from_numpy(x).double(), torch.from_numpy(w).half(),
                            torch.from_numpy(b))
    want = jax_conv3x3_bias_relu(jnp.asarray(x), jnp.asarray(w.astype(np.float16)),
                                 jnp.asarray(b), True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_gradients_match_pallas_vjp(rng):
    """dx, dW and db of sum(y^2) against jax.grad through the JAX custom
    VJP (its _conv_call and _dw_call in interpret mode)."""
    x, w, b = _inputs(rng, 2, 8, 4, 8)

    def loss(x, w, b):
        return jnp.sum(jax_conv3x3_bias_relu(x, w, b, True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    (conv3x3_bias_relu(tx, tw, tb) ** 2).sum().backward()
    for got, ref, name in zip((tx.grad, tw.grad, tb.grad), want, "xwb"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3,
                                   err_msg=f"grad {name}")


def test_conv3x3_is_differentiable_unlike_jax(rng):
    """The JAX conv3x3 calls _conv_call outside the custom VJP, so jax.grad
    cannot go through it; the port's conv3x3 is differentiable through
    K6a (dx) and K6b (dW) and agrees with jax.grad of the XLA conv."""
    x, w, b = _inputs(rng, 2, 8, 4, 8)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda w: jnp.sum(jax_conv3x3(jnp.asarray(x), w, None, True)))(
            jnp.asarray(w))

    def loss(x, w, b):
        return jnp.sum(jnp.sin(_xla_conv(x, w, b, relu=False)))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    torch.sin(conv3x3(tx, tw, tb)).sum().backward()
    for got, ref, name in zip((tx.grad, tw.grad, tb.grad), want, "xwb"):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-3,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("ci, co", [(4, 8), (3, 5)])
def test_plain_dw_matches_pallas(rng, ci, co):
    x = rng.standard_normal((3, 8, 8, ci)).astype(np.float32)
    g = rng.standard_normal((3, 8, 8, co)).astype(np.float32)
    want = _dw_call(jnp.asarray(x), jnp.asarray(g), interpret=True)
    got = conv3x3_dw(torch.from_numpy(x), torch.from_numpy(g))
    assert got.shape == (3, 3, ci, co)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(conv3x3_dw_plain(torch.from_numpy(x), torch.from_numpy(g)),
                               got.numpy(), atol=0)


def test_rotated_weight_is_the_vjp_transpose(rng):
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    want = np.transpose(w[::-1, ::-1], (0, 1, 3, 2))
    np.testing.assert_array_equal(rotate_weight(torch.from_numpy(w)).numpy(), want)


@pytest.mark.parametrize("fn", [Conv3x3BiasReLU, Conv3x3], ids=["bias_relu", "conv"])
def test_gradcheck_plain_path(fn):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 5, 3, dtype=torch.float64, generator=gen, requires_grad=True)
    w = torch.randn(3, 3, 3, 2, dtype=torch.float64, generator=gen, requires_grad=True)
    b = torch.randn(2, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(fn.apply, (x, w, b))


def test_cpu_tensors_take_the_plain_version(rng):
    x, w, b = _inputs(rng, 1, 8, 4, 4)
    before = (conv3x3_call.launches, conv3x3_dw.launches)
    tx = torch.from_numpy(x).requires_grad_()
    conv3x3_bias_relu(tx, torch.from_numpy(w), torch.from_numpy(b)).sum().backward()
    assert (conv3x3_call.launches, conv3x3_dw.launches) == before



def _tf32(t):
    """float32 -> TF32 as cvt.rna rounds: to nearest on the low 13 mantissa
    bits, ties away from zero (finite inputs)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(t):
    """The kernels' operand split: hi = tf32(t), lo = tf32(t - hi)."""
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _chop(t):
    """float64 -> float32 rounded toward zero: how the tensor cores
    normalise a float32 accumulation (an mma.sync adds its exact products
    to the accumulator and truncates the sum)."""
    f = t.float()
    return torch.where(f.double().abs() > t.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


def _hi(t):
    return _split(t)[0]


def _lo(t):
    return _split(t)[1]


# (x part, g part) of each MMA of a product, in K6b's order
THREE = [(_hi, _lo), (_lo, _hi), (_hi, _hi)]
SINGLE = [(_hi, _hi)]


def _dw_mma(x, g, parts):
    """dW (3, 3, Ci, Co) as K6b's m16n8k8 MMAs form it in one split:
    dW^T = G^T X over the pixels in (n, h, w) order, 8 pixels a step, each
    step adding the product of each (x part, g part) to one float32
    accumulator that truncates (_chop)."""
    n, h, w, ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + h, kx:kx + w] for ky in range(3) for kx in range(3)],
                       3).reshape(n * h * w, 9 * ci)
    gm = g.reshape(n * h * w, -1)
    pairs = [(a(cols).double(), b(gm).double()) for a, b in parts]
    acc = torch.zeros(9 * ci, gm.shape[1])
    for p in range(0, n * h * w, 8):
        for xa, ga in pairs:
            acc = _chop(acc.double() + xa[p:p + 8].T @ ga[p:p + 8])
    return acc.reshape(3, 3, ci, -1)


def _dw_errors(x, g):
    """(3xTF32, single TF32) emulated errors against float64, as shares of
    max |dW|."""
    want = conv3x3_dw_plain(x.double(), g.double())
    scale = float(want.abs().max())
    return [float((_dw_mma(x, g, parts).double() - want).abs().max()) / scale
            for parts in (THREE, SINGLE)]


def test_tf32_rounding_is_cvt_rna():
    got = _tf32(torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                              -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0]))
    want = [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    assert got.tolist() == want  # ties away from zero, else to nearest
    hi, lo = _split(torch.tensor([1.0 + 2.0 ** -11 + 2.0 ** -20]))
    assert float(hi + lo) == 1.0 + 2.0 ** -11 + 2.0 ** -20


def test_3xtf32_dw_error_budget(rng):
    """K6b's deepest reduction per pixel, UNet32's 8 x 8 layer with 512 x
    512 channels (the 9 x 512 x 512 products of a pixel), at N = 2, all
    128 pixels in one chain: 3xTF32 within a tenth of the gate, single
    TF32 past it."""
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 512)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 8, 8, 512)).astype(np.float32))
    err3, err1 = _dw_errors(x, g)
    assert err3 <= DW_RTOL / 10, err3
    assert err1 > DW_RTOL, err1
    assert err1 >= 10 * err3, (err1, err3)


def _source_constant(name, source="conv3x3.cu"):
    src = Path(__file__).resolve().parents[1] / "rfi_toolbox_tpu_torch/ops/csrc" / source
    return int(re.search(rf"constexpr int {name} = (\d+);", src.read_text()).group(1))


def test_3xtf32_dw_longest_chain(rng):
    """The longest chain a K6b split accumulates, kDwMaxChain chunks of
    kDwPixels pixels (read from the CUDA source), as 8 x 8 images at 64 x
    64 channels: the truncation grows with the chain, so this is K6b's
    worst case; within a quarter of the gate, single TF32 past it."""
    pixels = _source_constant("kDwMaxChain") * _source_constant("kDwPixels")
    x = torch.from_numpy(rng.standard_normal((pixels // 64, 8, 8, 64)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((pixels // 64, 8, 8, 64)).astype(np.float32))
    err3, err1 = _dw_errors(x, g)
    assert err3 <= DW_RTOL / 4, err3
    assert err1 > DW_RTOL, err1
    assert err1 >= 10 * err3, (err1, err3)


# (x part, w part) of each MMA of a product, in K6a's order (mma3_tiles:
# all lo*hi, then hi*lo, then hi*hi; A is the input, B the weights)
FORWARD = [(_lo, _hi), (_hi, _lo), (_hi, _hi)]


def _conv_mma(x, w, b, chunk_sums):
    """relu(conv3x3_SAME(x, w) + b), NHWC x, HWIO w, as K6a's m16n8k8 MMAs
    form it on the tensor cores in 3xTF32: K in steps of one tap x kKC = 8
    input channels (read from conv3x3_mma.cuh; channel chunks outer, taps
    inner), each MMA adding its exact
    products to a float32 accumulator that truncates (_chop). With
    chunk_sums, as K6a: each chunk's 27 MMAs go into a zeroed accumulator
    that is then added to the running sum in float32, rounded to nearest;
    without, one accumulator for all (K7's scheme). Then the bias and the
    ReLU in float32."""
    n, h, wd, ci = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.stack([xp[:, ky:ky + h, kx:kx + wd] for ky in range(3) for kx in range(3)], 1)
    pairs = [(a(cols).double(), c(w).double().reshape(9, ci, -1)) for a, c in FORWARD]
    chunk = _source_constant("kKC", "conv3x3_mma.cuh")  # input channels an MMA takes
    acc = torch.zeros(n, h, wd, w.shape[3])
    for c in range(0, ci, chunk):
        part = torch.zeros_like(acc) if chunk_sums else acc
        for t in range(9):
            for xa, wa in pairs:
                part = _chop(part.double() + xa[:, t, ..., c:c + chunk] @ wa[t, c:c + chunk])
        acc = acc + part if chunk_sums else part
    return torch.relu(acc + b)


def _k6a_errors(rng, ci, co=32, side=8, n=2):
    """(chunk sums, one running accumulator) emulated errors of a ci -> co
    conv + bias + ReLU on ReLU'd normal inputs, weights ~ N(0, 1/(9 ci)),
    against float64, as shares of the output's max."""
    x = torch.relu(torch.from_numpy(rng.standard_normal((n, side, side, ci)).astype(np.float32)))
    w = torch.from_numpy((rng.standard_normal((3, 3, ci, co)) / np.sqrt(9 * ci)).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(co)).astype(np.float32))
    want = torch.relu(F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(3, 2, 0, 1),
                               b.double(), padding=1)).permute(0, 2, 3, 1)
    scale = float(want.abs().max())
    return [float((_conv_mma(x, w, b, sums).double() - want).abs().max()) / scale
            for sums in (True, False)]


def test_3xtf32_k6a_emulation_matches_plain_conv(rng):
    """The emulation itself computes the conv: at a few channels it agrees
    with K6a's plain version to float32 rounding."""
    x = torch.from_numpy(rng.standard_normal((1, 6, 5, 11)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 11, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    want = conv3x3_call(x, w, b, relu=True)
    for sums in (True, False):
        np.testing.assert_allclose(_conv_mma(x, w, b, sums).numpy(), want.numpy(),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ci", [256, 512])
def test_3xtf32_k6a_chunk_sums(rng, ci):
    """K6a's deepest reductions: 256 input channels (the folded UNet16's
    8 x 8 bottleneck and the decoder after it) and 512 (the dx convs of
    UNet32's bottleneck). With K6a's per-chunk sums the truncating
    accumulation stays within a quarter of chip_smoke.py's 1e-5 gate;
    K7's one running accumulator would be at least 10x farther off."""
    chunked, running = _k6a_errors(rng, ci)
    assert chunked <= CONV_RTOL / 4, chunked
    assert running >= 10 * chunked, (running, chunked)
