"""Port parity: per-patch MAD flags (K5's plain version) against the JAX
package on the CPU. Tolerance: none, the flags must be identical."""

from pathlib import Path

import jax  # noqa: F401  (JAX on the CPU: conftest pins the platform)
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.ops import mad_flag_patches_pallas
from rfi_toolbox_tpu.preprocess import pipeline as JP
from rfi_toolbox_tpu_torch.ops import mad_flag_patches, mad_flag_patches_plain

GOLDEN = Path(__file__).parent / "golden" / "oracles.npz"


def _jax_flags(x, sigma):
    return np.asarray(JP.mad_flag_patches(x, sigma))


def _port_flags(x, sigma):
    return mad_flag_patches(torch.from_numpy(x), sigma).numpy()


def _visibilities(rng, shape):
    amp = rng.normal(1.0, 0.1, shape)
    amp[..., 3:5, :] += 1e4  # a stripe to flag
    z = amp * np.exp(1j * rng.uniform(0, 2 * np.pi, shape))
    return z.astype(np.complex64)


@pytest.mark.parametrize("shape", [(6, 32, 32), (3, 33, 31), (2, 64, 48)])
@pytest.mark.parametrize("sigma", [3.0, 5.0])
def test_complex_exact(rng, shape, sigma):
    z = _visibilities(rng, shape)
    got = _port_flags(z, sigma)
    assert got.dtype == bool and got.shape == shape
    np.testing.assert_array_equal(got, _jax_flags(z, sigma))


def test_nans_omitted_and_never_flagged(rng):
    z = _visibilities(rng, (4, 32, 32))
    z[rng.random(z.shape) < 0.05] = np.nan
    z[2] = np.nan + 0j  # an all-NaN patch: no median, nothing flagged
    z[3, :, :5] = np.complex64(complex(1.0, np.nan))  # NaN imaginary part
    got = _port_flags(z, 5.0)
    np.testing.assert_array_equal(got, _jax_flags(z, 5.0))
    assert not got[np.isnan(z)].any()
    assert not got[2].any()


def test_constant_patches(rng):
    z = np.full((3, 16, 16), 2 + 2j, np.complex64)
    z[1, 4, 4] = 50.0  # MAD 0: every pixel off the median is flagged
    got = _port_flags(z, 5.0)
    np.testing.assert_array_equal(got, _jax_flags(z, 5.0))
    assert got.sum() == 1


@pytest.mark.parametrize("sigma", [2.0, 5.0])
def test_negative_real_exact(rng, sigma):
    """Real input keeps its sign: the port follows pipeline.mad_flag_patches
    (the Pallas kernel's raw-bit order is wrong for negative values)."""
    x = (3.0 * rng.normal(size=(2, 32, 32))).astype(np.float32)
    x[0, :3] -= 40.0
    x[1, 7] = np.nan
    np.testing.assert_array_equal(_port_flags(x, sigma), _jax_flags(x, sigma))


@pytest.mark.parametrize("complex_input", [True, False])
def test_matches_pallas_interpret_on_nonnegative(rng, complex_input):
    z = _visibilities(rng, (4, 32, 32))
    x = z if complex_input else np.abs(z).astype(np.float32)
    want = np.asarray(mad_flag_patches_pallas(x, 5.0, interpret=True))
    np.testing.assert_array_equal(_port_flags(x, 5.0), want)


def test_mad_flags_golden():
    with np.load(GOLDEN) as g:
        patches, flags = g["input_patches"], g["mad_flags"]
    np.testing.assert_array_equal(_port_flags(patches, 5.0), flags)


def test_wrapper_on_cpu_runs_plain_version(rng):
    z = torch.from_numpy(_visibilities(rng, (2, 16, 16)))
    before = mad_flag_patches.launches
    out = mad_flag_patches(z, 5.0)
    assert mad_flag_patches.launches == before
    assert torch.equal(out, mad_flag_patches_plain(z, 5.0))


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        mad_flag_patches(torch.empty((1, 8, 8), device="meta"), 5.0)
