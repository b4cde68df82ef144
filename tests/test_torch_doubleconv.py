"""Port parity: K7 (double_conv_gn_relu) through its plain version on the
CPU, against the JAX package's fused DoubleConv kernel in interpret mode
and against the port's own DoubleConv(norm="group") eval forward.

Tolerance 2e-4 absolute and relative, the JAX package's own
(tests/test_ops.py::test_double_conv_gn_relu_parity).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.ops.fused_doubleconv import double_conv_gn_relu as jax_double_conv
from rfi_toolbox_tpu_torch.models.unet import DoubleConv
from rfi_toolbox_tpu_torch.ops import double_conv_gn_relu


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
