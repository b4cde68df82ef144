"""Port parity: patchify/unpatchify and the 3-channel extraction (K4's
plain version) against the JAX package, on the CPU.

Tolerance for the extraction: 2e-5, the bound the JAX package holds its
own Pallas kernel to (ops/fused_channels.py docstring); log10, atan2 and
sqrt come from different libraries on the two sides."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.ops import fused_extract_channels as jax_fused_extract
from rfi_toolbox_tpu.preprocess import pipeline as JP
from rfi_toolbox_tpu_torch.ops import (
    fused_extract_channels,
    fused_extract_channels_plain,
)
from rfi_toolbox_tpu_torch.preprocess import pipeline as TP

TOL = 2e-5
GOLDEN = Path(__file__).parent / "golden" / "oracles.npz"


def _complex(rng, shape, scale=1.0):
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return (scale * z).astype(np.complex64)


def _with_rfi(rng, n=4, h=64, w=64):
    """Noise with a bright stripe, a bright block and a near-zero patch."""
    z = _complex(rng, (n, h, w))
    z[0, 10:13, :] *= 1e4
    z[1, 20:40, 5:30] *= 1e6
    z[2] *= 1e-4
    return z


@pytest.mark.parametrize("shape,p", [((2, 200, 300), 64), ((1, 128, 128), 128),
                                     ((3, 50, 70), 64), ((2, 96, 130), 32)])
def test_patchify_matches_jax(rng, shape, p):
    wf = _complex(rng, shape)
    want = np.asarray(JP.patchify_batch(wf, p))
    got = TP.patchify_batch(torch.from_numpy(wf), p).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.complex64, np.float32, bool])
def test_unpatchify_roundtrip(rng, dtype):
    wf = (rng.normal(size=(2, 200, 300)) > 0.3).astype(dtype)
    t = torch.from_numpy(wf)
    back = TP.unpatchify_batch(TP.patchify_batch(t, 64), 2, 200, 300)
    np.testing.assert_array_equal(back.numpy(), wf)


def test_unpatchify_matches_jax(rng):
    patches = rng.normal(size=(40, 64, 64)).astype(np.float32)
    want = np.asarray(JP.unpatchify_batch(patches, 2, 200, 300))
    got = TP.unpatchify_batch(torch.from_numpy(patches), 2, 200, 300).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,patch,step", [((256, 256), (128, 128), 128),
                                              ((64, 64), (32, 32), 16),
                                              ((200, 150), (64, 64), 64),
                                              ((100, 90), (32, 48), 24)])
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_grid_patchify_matches_jax(rng, shape, patch, step, as_tensor):
    a = rng.random(shape).astype(np.float32)
    want = np.asarray(JP.patchify(a, patch, step))
    got = TP.patchify(torch.from_numpy(a) if as_tensor else a, patch, step)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_magnitude_matches_jax_bitwise(rng):
    """The scaled hypot reproduces jnp.abs bit for bit (normal floats,
    zeros, infinities and NaNs), which is what makes the MAD flags exact."""
    n = 200_000
    scale = rng.choice([1e-3, 1.0, 1e4, 1e-30, 1e30], size=(2, n))
    z = (rng.normal(size=n) * scale[0] + 1j * rng.normal(size=n) * scale[1])
    special = np.array([0.0, np.inf, -np.inf, np.nan, 1.0, -2.5], np.float32)
    grid = np.empty((special.size, special.size), np.complex64)
    grid.real, grid.imag = special[:, None], special[None, :]
    z = np.concatenate([z.astype(np.complex64), grid.ravel()])
    want = np.asarray(jax.numpy.abs(z))
    got = TP.magnitude(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)


def test_extract_channels_complex_matches_jax(rng):
    z = _with_rfi(rng)
    want = np.asarray(JP.imagenet_normalize(JP.extract_channels(z)))
    got = TP.imagenet_normalize(TP.extract_channels(torch.from_numpy(z)))
    assert got.shape == (4, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_extract_channels_real_matches_jax(rng):
    """Real input: min-max log_amp and a zero phase channel, as the jnp
    spec does (the Pallas kernel instead treats it as zero-imag complex)."""
    x = (3.0 * rng.normal(size=(3, 48, 40))).astype(np.float32)
    want = np.asarray(JP.imagenet_normalize(JP.extract_channels(x)))
    got = fused_extract_channels_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_plain_matches_pallas_interpret(rng):
    z = _with_rfi(rng, n=5, h=32, w=32)
    want = np.asarray(jax_fused_extract(z, interpret=True))
    got = fused_extract_channels_plain(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("value", [3 + 4j, 7.0])
def test_constant_patch_follows_spec(value):
    """A constant patch has an exactly zero gradient, so its min-max
    channels are 0 before the affine. (XLA's fused CPU log10 rounds the
    vector body and the tail of a row differently, so the jnp reference
    min-max-normalises that rounding noise up to [0, 1] here; the spec,
    and the port, give zeros.)"""
    x = np.full((2, 48, 40), value,
                np.complex64 if isinstance(value, complex) else np.float32)
    got = fused_extract_channels_plain(torch.from_numpy(x)).numpy()
    mean, std = JP.IMAGENET_MEAN, JP.IMAGENET_STD
    np.testing.assert_array_equal(got[..., 0], (0.0 - mean[0]) / std[0])
    if isinstance(value, complex):
        log_norm = (np.log10(np.float32(5.0)) + 3.0) / 7.0
        phase_norm = (np.arctan2(4.0, 3.0) + np.pi) / (2 * np.pi)
    else:
        log_norm, phase_norm = 0.0, 0.0
    np.testing.assert_allclose(got[..., 1], (log_norm - mean[1]) / std[1],
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got[..., 2], (phase_norm - mean[2]) / std[2],
                               atol=TOL, rtol=0)


def test_channels_golden():
    with np.load(GOLDEN) as g:
        patches, channels = g["input_patches"], g["channels"]
    got = fused_extract_channels_plain(torch.from_numpy(patches)).numpy()
    np.testing.assert_allclose(got, channels, atol=TOL, rtol=0)


def test_wrapper_on_cpu_runs_plain_version(rng):
    z = torch.from_numpy(_with_rfi(rng))
    before = fused_extract_channels.launches
    out = fused_extract_channels(z)
    assert fused_extract_channels.launches == before
    torch.testing.assert_close(out, fused_extract_channels_plain(z), rtol=0, atol=0)


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        fused_extract_channels(torch.empty((1, 8, 8), dtype=torch.complex64,
                                           device="meta"))
