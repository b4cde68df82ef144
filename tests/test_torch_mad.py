"""Port parity: per-patch MAD flags (K5's plain version) against the JAX
package on the CPU. Tolerance: none, the flags must be identical.

The test_digit_select_* tests hold a torch model of K5's kernel (its
order-preserving keys, its four 8-bit digit passes, its two-rank logic)
bit-equal to the plain version on patches chosen to break a radix
select."""

from pathlib import Path

import jax  # noqa: F401  (JAX on the CPU: conftest pins the platform)
import numpy as np
import pytest
import torch

from rfi_toolbox_tpu.ops import mad_flag_patches_pallas
from rfi_toolbox_tpu.preprocess import pipeline as JP
from rfi_toolbox_tpu_torch.ops import mad_flag_patches, mad_flag_patches_plain
from rfi_toolbox_tpu_torch.preprocess.pipeline import magnitude

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


# A model of K5's kernel (csrc/mad_flags.cu) in plain torch: the same keys,
# the same four 8-bit digit passes of the select, the same two-rank logic,
# the same float32 roundings. Keys are uint32 values held in int64.
NAN_KEY = 0xFFFFFFFF


def _order_key(x):
    """float32 -> the kernel's order-preserving key: every bit of a
    negative value flipped, the sign bit of a positive one set; NaN the
    largest."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 2 ** 31, ~u & 0xFFFFFFFF, u | 2 ** 31)
    return torch.where(torch.isnan(x), NAN_KEY, key)


def _key_value(key):
    """The float32 value of a key (its inverse)."""
    bits = torch.where(key >= 2 ** 31, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def _select_key(keys, rank):
    """select_key: the rank-th smallest non-NaN key, fixed 8 bits a pass
    from the top by a 256-bin histogram of the keys that share the
    digits fixed so far and a scan of the bins; also the keys below it
    and equal to it. NaN keys are counted, as the kernel counts them:
    they are the largest, so no rank below their number reaches them."""
    prefix, k, equal = 0, rank, 0
    for shift in (24, 16, 8, 0):
        high = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        inside = (keys & high) == prefix
        hist = torch.bincount((keys[inside] >> shift) & 0xFF, minlength=256)
        incl = torch.cumsum(hist, 0)
        excl = incl - hist
        (picked,) = torch.nonzero((excl <= k) & (k < incl))[:, 0].tolist()
        prefix |= picked << shift
        k -= int(excl[picked])
        equal = int(hist[picked])
    return prefix, rank - k, equal


def _median(keys, count):
    """median_of: the lower middle rank by the select, the upper one the
    same key when enough keys equal it, else the least key above it; their
    midpoint in float32."""
    k_lo, k_hi = (count - 1) // 2, count // 2
    lo, below, equal = _select_key(keys, k_lo)
    hi = lo if k_hi < below + equal else int(keys[keys > lo].min())
    pair = _key_value(torch.tensor([lo, hi]))
    return (pair[0] + pair[1]) * torch.tensor(0.5, dtype=torch.float32)


def _model_flags(x, sigma):
    """K5's flags of one patch (complex by magnitude), by the model."""
    t = torch.from_numpy(x)
    v = (magnitude(t) if t.is_complex() else t.float()).reshape(-1)
    keys = _order_key(v)
    count = int((keys != NAN_KEY).sum())
    if count == 0:
        return np.zeros(x.shape, bool)
    median = _median(keys, count)
    dev_keys = _order_key((_key_value(keys) - median).abs())
    count_dev = int((dev_keys != NAN_KEY).sum())
    mad = _median(dev_keys, count_dev) if count_dev else torch.tensor(float("nan"))
    spread = mad * torch.tensor(sigma, dtype=torch.float32)
    return ((v > median + spread) | (v < median - spread)).reshape(x.shape).numpy()


def _straddling(rng, lo_key, n_side):
    """A patch of 2 n_side + 2 values whose middle pair is the keys lo_key
    and lo_key + 1, the rest far below and above, shuffled."""
    mid = _key_value(torch.tensor([lo_key, lo_key + 1])).numpy()
    vals = np.concatenate([-3 - rng.random(n_side), mid, 3 + rng.random(n_side)])
    return rng.permutation(vals.astype(np.float32))


def _adversarial(rng):
    """Patches that stress the select: name -> (N, H, W) input."""
    vis = _visibilities(rng, (3, 16, 16))
    nan = vis.copy()
    nan[rng.random(nan.shape) < 0.1] = np.nan
    nan[1] = np.nan  # an all-NaN patch
    nan[2, 0, :3] = np.nan  # 253 valid: odd
    zeros = np.where(rng.random((3, 16, 16)) < 0.5, np.float32(-0.0), np.float32(0.0))
    zeros[1, :2] = rng.choice([-1e-3, 1e-3], (2, 16))
    zeros[2, 5, 5] = 9.0
    straddle = np.stack([
        _straddling(rng, lo, 127).reshape(16, 16)
        # lo's low bits all ones up to a digit, so lo and lo + 1 first
        # differ at that digit (top, second, third, last); -0.0 | +0.0;
        # two negatives across a digit
        for lo in (0xBEFFFFFF, 0xBF80FFFF, 0xBF8000FF, 0xBF800000, 0x7FFFFFFF, 0x40FFFFFF)])
    return {
        "all equal": np.full((2, 16, 16), 2.5, np.float32),
        "equal complex": np.full((2, 8, 8), 3 - 4j, np.complex64),
        "quantised": (np.round(4 * np.abs(vis)) / 4).astype(np.float32),
        "quantised negative": rng.integers(-2, 2, (3, 15, 15)).astype(np.float32),
        "straddle": straddle,
        "even and odd counts": np.abs(_visibilities(rng, (4, 15, 17))),
        "NaNs": nan,
        "negative real": (3 * rng.normal(size=(2, 16, 16)) - 5).astype(np.float32),
        "+-0.0": zeros,
    }


def test_digit_select_is_exact(rng):
    """The model's select returns the exact order statistics of the valid
    values, and the right counts of keys below and equal."""
    for name, x in _adversarial(rng).items():
        for patch in x.astype(np.complex64 if np.iscomplexobj(x) else np.float32):
            t = torch.from_numpy(patch)
            v = (magnitude(t) if t.is_complex() else t).reshape(-1)
            keys = _order_key(v)
            ranked = torch.sort(keys[keys != NAN_KEY]).values
            for rank in {0, (ranked.numel() - 1) // 2, ranked.numel() // 2,
                         ranked.numel() - 1} if ranked.numel() else ():
                key, below, equal = _select_key(keys, rank)
                assert key == int(ranked[rank]), (name, rank)
                assert below == int((ranked < key).sum()), (name, rank)
                assert equal == int((ranked == key).sum()), (name, rank)


@pytest.mark.parametrize("name", list(_adversarial(np.random.default_rng(0))))
def test_digit_select_model_bit_equal(name):
    """The model of the kernel's 8-bit digit select gives the plain
    version's flags bit for bit on the cases that stress it: equal keys,
    quantised levels, middle pairs straddling a bin at each digit, even and
    odd valid counts, NaNs and an all-NaN patch, negative reals, +-0.0."""
    x = _adversarial(np.random.default_rng(7))[name]
    want = mad_flag_patches_plain(torch.from_numpy(x), 5.0).numpy()
    got = np.stack([_model_flags(patch, 5.0) for patch in x])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_port_flags(x, 5.0), _jax_flags(x, 5.0))
